"""The port's model zoo against the JAX package's, on the CPU.

Every architecture at ``.smoke()`` runs the same tokens (seeded numpy)
through both packages from the same weights: the JAX package's
``Model.init`` draw, carried into the port with ``params_from_arrays``.
Logits agree within ``rtol=1e-4, atol=1e-4 * max|logits|`` in float32 (the
two frameworks sum in different orders), and within ``rtol=3e-2, atol=3e-2
* max|logits|`` for OLMo in bf16 (each framework rounds its bf16 products
at its own places).  Prefill plus cached decode equals the full forward
(the JAX package's own tolerance), and the prefilled cache equals the JAX
package's; the MoE router's ties go to the lower expert as ``lax.top_k``
puts them; the SSD scan and the blockwise attention agree with the JAX
package's.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.moe as jmoe
import repro.models.ssm as jssm
from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
import repro_torch.models.attention as tattn
import repro_torch.models.moe as tmoe
import repro_torch.models.ssm as tssm
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model, params_from_arrays, tree_map
from repro_torch.models.layers import grad_dtype_guard

ROOT = Path(__file__).resolve().parents[1]
B, S, P = 2, 16, 12
F32_TOL = 1e-4
BF16_TOL = 3e-2


def _batch(cfg, seed=1):
    """The same batch (seeded numpy) for jax and for torch."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.int64 if k == "tokens" else torch.float32)
          for k, v in batch.items()}
    return jb, tb


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str = "float32"):
    """The JAX model, its weights (numpy) and its full-forward logits."""
    cfg = dataclasses.replace(J_ARCHS[arch].smoke(), dtype=dtype)
    model = j_build_model(cfg)
    params = model.init(jax.random.key(0))
    logits, _, aux = model.forward(params, _batch(cfg)[0])
    return model, params, jax.tree.map(np.asarray, params), np.asarray(logits), float(aux)


def _port(arch: str, dtype: str = "float32"):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    return cfg, build_model(cfg), params_from_arrays(_reference(arch, dtype)[2], device="cpu")


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=what)


def test_configs_are_the_reference_configs():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name in ARCHS:
        for full in (True, False):
            mine = get_config(name) if full else get_config(name).smoke()
            ref = J_ARCHS[name] if full else J_ARCHS[name].smoke()
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
            assert (mine.param_count(), mine.active_param_count()) == (
                ref.param_count(), ref.active_param_count()), name
            assert [mine.layer_kind(l) for l in range(mine.n_layers)] == [
                ref.layer_kind(l) for l in range(ref.n_layers)]
    olmo = get_config("olmo-1b")
    assert (olmo.n_layers, olmo.d_model, olmo.d_ff, olmo.vocab) == (16, 2048, 8192, 50304)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_the_reference(arch):
    _, _, _, want, aux_want = _reference(arch)
    cfg, model, params = _port(arch)
    # the parameter trees carry over key for key, in the shapes the defs give
    shapes = tree_map(lambda d: tuple(d.shape), model.defs)
    assert tree_map(lambda t: tuple(t.shape), params) == shapes
    logits, cache, aux = model.forward(params, _batch(cfg)[1])
    assert cache is None and logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.padded_vocab)
    _close(logits, want, F32_TOL, arch)
    np.testing.assert_allclose(float(aux), aux_want, rtol=1e-5, atol=1e-7)


def test_olmo_bf16_forward_matches_the_reference():
    _, _, tree, want, _ = _reference("olmo-1b", "bfloat16")
    cfg, model, params = _port("olmo-1b", "bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(params))
    logits, _, _ = model.forward(params, _batch(cfg)[1])
    _close(logits, want, BF16_TOL, "olmo-1b bf16")


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_decode_matches_full_forward(arch):
    """Prefill P tokens, decode the rest one at a time: each step's logits
    equal the full forward's (the JAX package's test, its tolerance); the
    prefilled cache equals the JAX package's."""
    jmodel, jparams, _, _, _ = _reference(arch)
    cfg, model, params = _port(arch)
    jb, tb = _batch(cfg)
    full, _, _ = model.forward(params, tb)
    cache = model.init_cache(B, S + 4, cross_len=S, device="cpu")
    pre = {k: (v[:, :P] if k == "tokens" else v) for k, v in tb.items()}
    logits_pre, cache_out, _ = model.forward(params, pre, cache=cache, pos0=0)
    assert cache_out is cache  # written in place
    np.testing.assert_allclose(logits_pre.numpy(), full[:, :P].numpy(), atol=2e-4, rtol=1e-3)

    jcache = jmodel.init_cache(B, S + 4, cross_len=S)
    jpre = {k: (v[:, :P] if k == "tokens" else v) for k, v in jb.items()}
    _, jcache, _ = jmodel.forward(jparams, jpre, cache=jcache, pos0=0)
    got, want = tree_map(lambda t: t.float().numpy(), cache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL * max(np.abs(w).max(), 1e-30))

    for t in range(P, S):
        logits_d, cache, _ = model.forward(params, {"tokens": tb["tokens"][:, t : t + 1]},
                                           cache=cache, pos0=t)
        np.testing.assert_allclose(logits_d[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-4, rtol=1e-3)


def test_unstacked_layers_match_the_reference():
    """``scan_layers=False`` (the JAX dry-run's layout): one ``g{i}``
    subtree per group, in the parameters and in the cache."""
    cfg = dataclasses.replace(J_ARCHS["olmo-1b"].smoke(), scan_layers=False)
    jmodel = j_build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    jb, tb = _batch(cfg)
    want, _, _ = jmodel.forward(jparams, jb)
    model = build_model(dataclasses.replace(get_config("olmo-1b").smoke(), scan_layers=False))
    params = params_from_arrays(jax.tree.map(np.asarray, jparams), device="cpu")
    assert sorted(params["dec"]) == ["g0", "g1"]
    logits, _, _ = model.forward(params, tb)
    _close(logits, want, F32_TOL)
    cache = model.init_cache(B, S, device="cpu")
    _, cache, _ = model.forward(params, {"tokens": tb["tokens"][:, :P]}, cache=cache)
    jcache = jmodel.init_cache(B, S)
    _, jcache, _ = jmodel.forward(jparams, {"tokens": jb["tokens"][:, :P]}, cache=jcache)
    for g, w in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), cache)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jcache))):
        _close(g, w, F32_TOL)


def test_a_float64_model_computes_wholly_in_float64():
    """A float64 copy (the card's reference for the full-width decode
    check and the float64 train step) keeps float64 through norms, scores,
    cache and logits: its cached decode equals its full forward to float64
    rounding."""
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), dtype="float64")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"]["tok"].dtype == torch.float64
    tokens = _batch(cfg)[1]["tokens"]
    full, _, _ = model.forward(params, {"tokens": tokens})
    assert full.dtype == torch.float64
    cache = model.init_cache(B, S, device="cpu")
    assert cache["dec"]["stack"]["l0"]["attn"]["k"].dtype == torch.float64
    _, cache, _ = model.forward(params, {"tokens": tokens[:, :P]}, cache=cache)
    for t in range(P, S):
        step, cache, _ = model.forward(params, {"tokens": tokens[:, t : t + 1]}, cache=cache,
                                       pos0=t)
        # float64 logits: within float64 rounding
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(), rtol=1e-11, atol=1e-12)


def _moe_case(seed, tie: bool, S_len: int):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke(), capacity_factor=1.0)
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.moe_experts, cfg.d_ff
    p = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * 0.1,
        "wg": rng.standard_normal((E, D, F)).astype(np.float32) / 8,
        "w1": rng.standard_normal((E, D, F)).astype(np.float32) / 8,
        "w2": rng.standard_normal((E, F, D)).astype(np.float32) / 11,
    }
    if tie:  # experts 2 and 3 copy 1: a three-way tie meets the top-2 cut
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 1]
    x = rng.standard_normal((2, S_len, D)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("tie, S_len", [(True, 16), (True, 1), (False, 16)])
def test_moe_matches_the_reference_with_tied_router_probabilities(tie, S_len):
    cfg, p, x = _moe_case(3, tie, S_len)
    y_j, aux_j = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    y_t, aux_t = tmoe.moe_apply(tree_map(torch.as_tensor, p), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    if tie:
        # the lower of the tied experts wins: expert 1 in every token's top 2
        # (as top-1 where expert 0 does not lead, then with 2 beside it), so
        # 16 slots per sequence meet its capacity of 8 and slots are dropped
        probs = torch.softmax(torch.as_tensor(x) @ torch.as_tensor(p["router"]), -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :2]
        assert bool(torch.all((top == 1).any(-1))) and not bool(torch.any(top == 3))
        assert bool(torch.all(top[..., 0] != 2))


def test_ssd_chunked_matches_the_reference_when_the_chunk_does_not_divide():
    rng = np.random.default_rng(4)
    Bn, Sn, nh, hp, n = 2, 13, 3, 4, 5
    x = rng.standard_normal((Bn, Sn, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bn, Sn, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    Bm = rng.standard_normal((Bn, Sn, n)).astype(np.float32)
    Cm = rng.standard_normal((Bn, Sn, n)).astype(np.float32)
    s0 = rng.standard_normal((Bn, nh, n, hp)).astype(np.float32)
    for init in (None, s0):
        y_j, st_j = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 5,
                                     None if init is None else jnp.asarray(init))
        y_t, st_t = tssm.ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)), 5,
                                     None if init is None else torch.as_tensor(init))
        _close(y_t, y_j, 1e-5)
        _close(st_t, st_j, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_the_reference(causal):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 32, 4, 8)).astype(np.float32) for _ in range(3))
    pos = np.arange(32)
    y_j = jattn._blockwise_attend(*map(jnp.asarray, (q, k, v, pos, pos)), causal, 8, 16)
    y_t = tattn._blockwise_attend(*map(torch.as_tensor, (q, k, v, pos, pos)), causal, 8, 16)
    _close(y_t, y_j, 1e-5)
    # and it is the dense path's attention
    dense = tattn._dense_attend(*map(torch.as_tensor, (q, k, v, pos, pos)), causal)
    _close(y_t, dense, 1e-5)


def _init_digest(seed: int) -> str:
    code = (
        "import hashlib, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build_model, tree_map\n"
        "m = build_model(get_config('jamba-1.5-large-398b').smoke())\n"
        f"p = m.init(torch.Generator().manual_seed({seed}), device='cpu')\n"
        "h = hashlib.sha256()\n"
        "tree_map(lambda t: h.update(t.numpy().tobytes()), p)\n"
        "print(h.hexdigest())\n"
    )
    digests = set()
    for hashseed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=hashseed)
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        digests.add(out.stdout.strip())
    assert len(digests) == 1, "init changed with the process's string-hash salt"
    return digests.pop()


def test_init_is_deterministic_across_processes():
    """The JAX package folds ``hash(path)`` into its keys, which Python
    salts per process; the port seeds each leaf from a crc32 of its path."""
    assert _init_digest(0) != _init_digest(1)
    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert tree_map(lambda t: tuple(t.shape), p) == tree_map(lambda d: d.shape, model.defs)
    w = p["dec"]["stack"]["l0"]["ffn"]["w1"]  # [groups, d, f], sigma 1/sqrt(d)
    sigma = 1 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2 * sigma
    assert 0.8 * sigma < float(w.std()) < sigma  # a normal cut at ±2σ keeps 0.88σ
    assert float(p["embed"]["tok"].abs().max()) <= 2 * 0.02
    mamba = build_model(get_config("mamba2-370m").smoke()).init(
        torch.Generator().manual_seed(0), device="cpu")["dec"]["stack"]["l0"]["mamba"]
    assert torch.all(mamba["dt_bias"] == -4.6) and torch.all(mamba["D"] == 1)
    np.testing.assert_allclose(mamba["A_log"][0].numpy(),
                               np.log(np.linspace(1, 16, mamba["A_log"].shape[-1])), rtol=1e-6)


def test_params_from_arrays_carries_bf16_exactly():
    tree = _reference("olmo-1b", "bfloat16")[2]
    leaf = tree["embed"]["tok"]
    assert leaf.dtype.name == "bfloat16"
    carried = params_from_arrays(tree, device="cpu")
    t = carried["embed"]["tok"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), leaf.astype(np.float32))
    as_f32 = params_from_arrays(tree, device="cpu", dtype=torch.float32)
    assert as_f32["embed"]["tok"].dtype == torch.float32


def test_grad_dtype_guard_casts_the_gradient():
    x = torch.randn(3, dtype=torch.bfloat16, requires_grad=True)
    y = grad_dtype_guard(x)
    assert torch.equal(y, x)
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
