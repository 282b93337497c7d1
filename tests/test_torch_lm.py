"""The port's LM serving path against the JAX package's, on the CPU.

* ``magnitude_prune`` equals the JAX package's bit for bit, and
  ``SparseLinear.from_dense`` admits the same tiles;
* ``SparseLinear.apply`` (``backend="torch"``, the einsum oracle) agrees
  with the JAX package's ``"jnp"`` backend, and both backends with the
  pruned dense product within ``1e-5 * (|x| |W|ᵀ)``; the block of tokens
  (the fused SpMM, plain version on the CPU) equals the per-token SpMVs
  bit for bit;
* ``Engine.generate`` (greedy, OLMo smoke, vocab 128, two layers) gives
  the JAX engine's tokens at every step whose top-2 logit gap in the JAX
  package's logits exceeds ``1e-3`` (a nearer tie may go either way under
  another summation order), and every step's logits, teacher-forced on the
  JAX engine's tokens, agree within ``rtol=1e-4, atol=1e-4 * max|logits|``;
* sampling is deterministic for a seed; the launcher runs on the CPU.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.sparse_linear import SparseLinear as JSparseLinear
from repro.core.sparse_linear import magnitude_prune as j_prune
from repro.models import build_model as j_build_model
from repro.serve import make_decode_step as j_decode_step
from repro.serve import make_prefill_step as j_prefill_step
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.sparse_linear import SparseLinear, magnitude_prune
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_arrays
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.serve.engine import Engine, EngineConfig, Request

RTOL = 1e-5
GAP = 1e-3
PLENS = (5, 7, 5, 6)  # two batches of two, left-padded to 7 and 6
MAX_NEW = 8
VOCAB = 128  # padded to 256


def _weights(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 0.97])
def test_magnitude_prune_is_the_reference_bit_for_bit(sparsity):
    for shape, seed in (((64, 96), 0), ((300, 700), 1)):
        w = _weights(shape, seed)
        w[3, :5] = 0.25  # ties at the threshold side by side
        got, want = magnitude_prune(w, sparsity), j_prune(w, sparsity)
        assert got.dtype == want.dtype and np.array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError):
        magnitude_prune(w, 1.0)


@pytest.fixture(scope="module")
def layers():
    """One weight [out, in] = [300, 700] (two column blocks of 512, two row
    blocks of 256) admitted by both packages at 90 % sparsity."""
    w = _weights((300, 700), 2)
    j = JSparseLinear.from_dense(w, sparsity=0.9)
    t = SparseLinear.from_dense(w, sparsity=0.9, backend="torch", device="cpu")
    f = SparseLinear.from_dense(w, sparsity=0.9, device="cpu")  # "cuda": fused
    return w, j, t, f


def test_sparse_linear_admits_the_reference_tiles(layers):
    w, j, t, f = layers
    for mine in (t, f):
        for name in ("data", "cols", "rowgroup", "colblock", "first", "perm"):
            assert np.array_equal(getattr(mine.tiles, name), getattr(j.tiles, name)), name
        assert (mine.out_features, mine.in_features) == (300, 700)
        assert mine.density() == j.density()
        assert mine.dt.device == torch.device("cpu")
    assert (t.backend, f.backend) == ("torch", "cuda")
    with pytest.raises(ValueError):
        SparseLinear.from_dense(w, backend="pallas", device="cpu")


@pytest.mark.parametrize("tokens", [(), (1,), (4,), (2, 3), (48,)])
def test_sparse_linear_apply_matches_the_reference_and_the_pruned_product(layers, tokens):
    w, j, t, f = layers
    x = np.random.default_rng(7).standard_normal(tokens + (700,)).astype(np.float32)
    pruned = magnitude_prune(w, 0.9).astype(np.float64)
    want = x.astype(np.float64) @ pruned.T
    bound = RTOL * (np.abs(x).astype(np.float64) @ np.abs(pruned).T) + 1e-30
    y_j = np.asarray(j.apply(jnp.asarray(x)))
    for layer in (t, f):
        y = layer.apply(torch.as_tensor(x))
        assert y.dtype == torch.float32 and y.shape == tokens + (300,)
        assert np.all(np.abs(y.numpy() - want) <= bound), layer.backend
        np.testing.assert_allclose(y.numpy(), y_j, rtol=RTOL, atol=RTOL * np.abs(y_j).max())


def test_sparse_linear_block_is_the_per_token_spmv_bit_for_bit(layers):
    _, _, _, f = layers
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((4, 700)).astype(np.float32))
    block = f.apply(x)
    for i in range(4):
        assert torch.equal(block[i], f.apply(x[i])), i
    assert torch.equal(f.apply(x.to(torch.bfloat16)), f.apply(x.to(torch.bfloat16).float()))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _cfg(package_get_config):
    return dataclasses.replace(package_get_config("olmo-1b").smoke(), n_layers=2, vocab=VOCAB)


@pytest.fixture(scope="module")
def lm():
    jmodel = j_build_model(_cfg(j_get_config))
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(_cfg(get_config))
    params = params_from_arrays(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in PLENS]
    return jmodel, jparams, model, params, prompts


def _teacher_forced(lm, outs):
    """Per batch: each step's logits of both packages, fed the JAX
    engine's tokens; returns [(jax logits, port logits)] per batch."""
    jmodel, jparams, model, params, prompts = lm
    jpre, jdec = jax.jit(j_prefill_step(jmodel)), jax.jit(j_decode_step(jmodel))
    tpre, tdec = make_prefill_step(model), make_decode_step(model)
    runs = []
    for lo in range(0, len(prompts), 2):
        group = prompts[lo : lo + 2]
        plen = max(p.size for p in group)
        toks = np.zeros((2, plen), np.int32)
        for i, p in enumerate(group):
            toks[i, plen - p.size :] = p
        fed = np.stack(outs[lo : lo + 2])  # [2, MAX_NEW]
        jcache = jmodel.init_cache(2, 64, cross_len=plen)
        jcache, jl = jpre(jparams, {"tokens": jnp.asarray(toks)}, jcache)
        tcache = model.init_cache(2, 64, cross_len=plen, device="cpu")
        tcache, tl = tpre(params, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}, tcache)
        steps = [(np.asarray(jl), tl.numpy())]
        for s in range(MAX_NEW - 1):
            cur = fed[:, s : s + 1]
            jcache, _, jl = jdec(jparams, jcache, jnp.asarray(cur), jnp.asarray(plen + s, jnp.int32))
            tcache, _, tl = tdec(params, tcache, torch.as_tensor(cur, dtype=torch.int64), plen + s)
            steps.append((np.asarray(jl), tl.numpy()))
        runs.append(steps)
    return runs


def test_greedy_engine_gives_the_reference_tokens(lm):
    jmodel, jparams, model, params, prompts = lm
    jreqs = [JRequest(prompt=p.copy(), max_new=MAX_NEW) for p in prompts]
    JEngine(jmodel, jparams, JEngineConfig(batch=2, max_len=64)).generate(jreqs)
    reqs = [Request(prompt=p.copy(), max_new=MAX_NEW) for p in prompts]
    Engine(model, params, EngineConfig(batch=2, max_len=64), device="cpu").generate(reqs)
    jouts = [r.out for r in jreqs]

    clear = np.zeros((len(prompts), MAX_NEW), bool)  # top-2 gap above GAP
    for b, steps in enumerate(_teacher_forced(lm, jouts)):
        for s, (jl, tl) in enumerate(steps):
            # the padded vocab columns hold -1e30 in both; the rest agree
            assert np.all(tl[:, VOCAB:] == -1e30) and np.all(jl[:, VOCAB:] == -1e30)
            jl, tl = jl[:, :VOCAB], tl[:, :VOCAB]
            np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
            top2 = np.sort(jl, axis=-1)[:, -2:]
            gap = top2[:, 1] - top2[:, 0]
            for i in range(2):
                assert jl[i].argmax() == jouts[2 * b + i][s]
                clear[2 * b + i, s] = gap[i] > GAP
                if clear[2 * b + i, s]:
                    assert tl[i].argmax() == jl[i].argmax(), (b, s, i)
    assert clear.mean() > 0.5  # most steps are decided by a clear margin
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        assert r.out.dtype == np.int32 and r.out.shape == (MAX_NEW,)
        # equal up to the first step a near tie may have sent another way
        n = MAX_NEW if clear[i].all() else int(np.argmin(clear[i]))
        assert np.array_equal(r.out[:n], jr.out[:n]), i


def test_sampling_is_deterministic_for_a_seed(lm):
    _, _, model, params, prompts = lm

    def run(seed):
        reqs = [Request(prompt=p.copy(), max_new=MAX_NEW) for p in prompts]
        cfg = EngineConfig(batch=2, max_len=64, temperature=1.0, seed=seed)
        Engine(model, params, cfg, device="cpu").generate(reqs)
        return np.stack([r.out for r in reqs])

    a, b, c = run(3), run(3), run(4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 128
    with pytest.raises(ValueError, match="max_len"):
        Engine(model, params, EngineConfig(batch=2, max_len=8), device="cpu").generate(
            [Request(prompt=prompts[0], max_new=8)])


def test_serve_cli_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--sparsity", "0.9"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("HBP sparse FFNs: target sparsity 0.9, density 0.1")
    assert lines[1].startswith("served 3 requests, 12 tokens in ")
    assert lines[1].endswith("tok/s on the host CPU)")
    assert [l.split(":")[0] for l in lines[2:]] == ["req0", "req1", "req2"]
    assert len(json.loads(lines[2].split(": ", 1)[1])) == 4
