"""The port's LM training path against the JAX package's, on the CPU.

Weights are the JAX package's ``Model.init`` draw carried into the port
with ``params_from_arrays``, optimizer states are carried with
``load_opt_state``, and batches come from the seed (numpy on both sides).

* ``SyntheticLM.batch_at`` equals the JAX package's for any
  ``(seed, step, lo, hi)``; ``_sqrt_factor`` equals its.
* For every architecture's ``smoke()`` config, ``loss_fn`` agrees with
  the JAX package's within ``rtol=1e-5`` and every gradient leaf within
  ``rtol=tol, atol=tol * max|leaf|`` (float32; the two frameworks sum in
  different orders), ``tol = 1e-4`` up to 4 layers and growing with the
  depth the backward crosses beyond (jamba's 16-layer smoke stack:
  ``4e-4``; its SSM leaves reach 1.5e-4 under some CPU thread counts),
  with ``remat`` off and on; in the port ``remat``
  changes no bit of the loss or of the gradients.  Also at a depth where
  the two-level split runs (four groups, two outer runs of two).
* MoE at a capacity that drops slots: the same tolerances, and
  ``_permute``'s gradient equals the JAX custom VJP's bit for bit, zero
  signs included, on the index maps the routing makes.
* ``make_train_step`` with ``n_microbatch`` 1 and 2, one step under int8
  moments and two under f32: loss and grad norm within ``rtol=1e-5``; f32
  moments within ``rtol=1e-4, atol=1e-4 * max|leaf|`` and int8 moments'
  ``q`` within one step of the JAX package's (a value on a rounding
  boundary may go either way); parameters within ``rtol=1e-5, atol=1e-5 *
  max|leaf| + 1e-2 * lr`` wherever the gradient was resolved at every step
  (the JAX package's first moment at least ``1e-4`` of its leaf's largest,
  the gradients' own tolerance; the update ``lr * m / sqrt(v)`` reads the
  ratio of the steps' gradients, which a small resolved gradient's rounding
  moves by up to about 1 %), and everywhere within ``2 * lr`` a step: in its first two
  steps AdamW moves a weight by at most ``1.0003 * lr`` (``b1 = 0.9``,
  ``b2 = 0.95``), the sign of an unresolved gradient's ``m / sqrt(v)``
  may go either way.  Only one int8 step is compared: the JAX package
  quantizes ``v`` with no floor, so a small ``v`` stored as 0 makes the
  next update ``m / eps``, where a ``q`` one step apart moves a weight
  arbitrarily far.
* The per-layer AdamW update (``_SCAN_LIMIT`` lowered) equals the
  whole-leaf update bit for bit, and the JAX package's whole-leaf update
  within float32 rounding (``rtol=1e-6``, as ``tests/test_torch_train.py``;
  moments with ``atol=1e-6 * max|leaf|``, since the clip factor's own
  rounding differs).
* ``Trainer``: a 6-step loss history within ``rtol=1e-4`` of the JAX
  package's; a run of 3 steps, a checkpoint and a resume to 6 give the
  parameters of 6 straight steps bit for bit.
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs and logs.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro.optim.adamw as jadamw
import repro.train.steps as jsteps
from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build_model
from repro.models.transformer import _sqrt_factor as j_sqrt_factor
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttransformer
import repro_torch.optim.adamw as tadamw
import repro_torch.train.steps as tsteps
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, params_from_arrays, tree_map
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.train.trainer import Trainer, TrainerConfig

B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAMW = dict(lr_peak=1e-3, warmup_steps=2, decay_steps=50)


def _batch(cfg, seed=1, b=B):
    """The same batch (seeded numpy) for jax and for torch."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((b, S, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.int64 if k == "tokens" else torch.float32)
          for k, v in batch.items()}
    return jb, tb


def _models(arch, **changes):
    """(JAX model, its weights, the port's model, the weights carried)."""
    jcfg = dataclasses.replace(J_ARCHS[arch].smoke(), **changes)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **changes)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = build_model(tcfg)
    return jmodel, jparams, tmodel, params_from_arrays(jax.tree.map(np.asarray, jparams),
                                                      device="cpu")


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=what)


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict, for comparing trees leaf by leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _grad_tol(cfg) -> float:
    return GRAD_TOL * max(1.0, cfg.n_layers / 4)


def _grads_close(t_grads, j_grads, what, tol=GRAD_TOL):
    t, j = _paths(t_grads), _paths(jax.tree.map(np.asarray, j_grads))
    assert t.keys() == j.keys()
    for key in t:
        _close(t[key], j[key], tol, f"{what} {key}")


def _port_loss_and_grads(model, params, batch, remat):
    leaves, rebuild = tadamw.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, parts = tsteps.loss_fn(model, rebuild(live), batch, remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), parts, rebuild(grads)


def _jax_loss_and_grads(model, params, batch, remat):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(model, p, b, remat=remat), has_aux=True))
    (loss, parts), grads = fn(params, batch)
    return loss, parts, grads


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,lo,hi", [(0, 0, 0, None), (3, 17, 0, None), (5, 2, 2, 6),
                                             (7, 1000, 1, 3)])
def test_batches_equal_the_reference(seed, step, lo, hi):
    jcfg = JDataConfig(vocab=1000, seq_len=32, global_batch=8, seed=seed)
    tcfg = DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=seed)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = JSyntheticLM(jcfg).batch_at(step, lo=lo, hi=hi)["tokens"]
    got = SyntheticLM(tcfg).batch_at(step, lo=lo, hi=hi)["tokens"]
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    if lo == 0 and hi is None:
        on_cpu = make_global_batch(SyntheticLM(tcfg), step, device="cpu")["tokens"]
        assert on_cpu.dtype == torch.int64 and np.array_equal(on_cpu.numpy(), want)
    first = [b["tokens"] for b, _ in zip(SyntheticLM(tcfg), range(3))]
    assert all(np.array_equal(f, JSyntheticLM(jcfg).batch_at(i)["tokens"])
               for i, f in enumerate(first))


def test_sqrt_factor_is_the_reference():
    assert [ttransformer._sqrt_factor(n) for n in range(1, 200)] == [
        j_sqrt_factor(n) for n in range(1, 200)]
    assert ttransformer._sqrt_factor(16) == 4 and ttransformer._sqrt_factor(7) == 1


# --- loss and gradients, every architecture ----------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_the_reference(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    jb, tb = _batch(tmodel.cfg)
    bits = {}
    for remat in (False, True):
        jloss, jparts, jgrads = _jax_loss_and_grads(jmodel, jparams, jb, remat)
        tloss, tparts, tgrads = _port_loss_and_grads(tmodel, tparams, tb, remat)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tparts["aux"].detach()), float(jparts["aux"]), rtol=1e-5,
                                   atol=1e-7)
        _grads_close(tgrads, jgrads, f"{arch} remat={remat}", _grad_tol(tmodel.cfg))
        bits[remat] = (tloss, tadamw.tree_leaves(tgrads))
    # recomputation in the backward gives the same bits
    assert torch.equal(bits[False][0], bits[True][0])
    assert all(torch.equal(a, b) for a, b in zip(bits[False][1], bits[True][1]))


def test_two_level_remat_matches_the_reference(monkeypatch):
    """Four stacked groups: each group checkpointed, and two outer runs of
    two groups checkpointed again (``n_inner = _sqrt_factor(4) = 2``)."""
    jmodel, jparams, tmodel, tparams = _models("olmo-1b", n_layers=4)
    jb, tb = _batch(tmodel.cfg)
    calls = []
    real = ttransformer.checkpoint
    monkeypatch.setattr(ttransformer, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn.__name__) or real(fn, *a, **k))
    with torch.no_grad():
        tmodel.forward(tparams, tb, remat=True)
    assert calls == ["outer", "group_apply", "group_apply"] * 2
    want_loss, _, want = _jax_loss_and_grads(jmodel, jparams, jb, True)
    plain = _port_loss_and_grads(tmodel, tparams, tb, False)
    loss, _, grads = _port_loss_and_grads(tmodel, tparams, tb, True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _grads_close(grads, want, "olmo-1b 4 layers, remat")
    assert all(torch.equal(a, b) for a, b in zip(tadamw.tree_leaves(grads),
                                                  tadamw.tree_leaves(plain[2])))


def test_stack_gradient_is_one_stacked_tensor():
    """The stack is unbound once per call: each stacked weight's gradient
    comes from one ``stack`` of the per-group gradients."""
    _, _, tmodel, tparams = _models("olmo-1b", n_layers=4)
    w1 = tparams["dec"]["stack"]["l0"]["ffn"]["w1"].detach().requires_grad_()
    tparams["dec"]["stack"]["l0"]["ffn"]["w1"] = w1
    loss, _ = tsteps.loss_fn(tmodel, tparams, _batch(tmodel.cfg)[1])
    seen = []

    def walk(fn):
        if fn is None or fn in seen:
            return
        seen.append(fn)
        for nxt, _ in fn.next_functions:
            walk(nxt)

    walk(loss.grad_fn)
    users = [type(f).__name__ for f in seen for nxt, _ in f.next_functions
             if nxt is not None and getattr(nxt, "variable", None) is w1]
    assert users == ["UnbindBackward0"]


def test_decode_is_unchanged_by_the_stack_unbind(monkeypatch):
    """Serving after the once-per-call unbind: the engine's tokens and a
    full forward's logits equal those of indexing the stack group by
    group (the previous code), bit for bit."""
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=4, vocab=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.random.default_rng(i).integers(0, 128, 6).astype(np.int32) for i in range(2)]

    def serve():
        reqs = [Request(prompt=p.copy(), max_new=8) for p in prompts]
        Engine(model, params, EngineConfig(batch=2, max_len=64), device="cpu").generate(reqs)
        seq = np.stack([np.concatenate([p, r.out]) for p, r in zip(prompts, reqs)])
        full, _, _ = model.forward(params, {"tokens": torch.as_tensor(seq, dtype=torch.int64)})
        return np.stack([r.out for r in reqs]), full

    tokens, logits = serve()
    monkeypatch.setattr(ttransformer, "_unbind", lambda stacked, n: [
        tree_map(lambda a: a[g], stacked) for g in range(n)])
    tokens_indexed, logits_indexed = serve()
    assert np.array_equal(tokens, tokens_indexed) and torch.equal(logits, logits_indexed)


# --- MoE at a capacity that drops slots --------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_moe_gradients_match_the_reference_with_dropped_slots(arch, monkeypatch):
    jmodel, jparams, tmodel, tparams = _models(arch, capacity_factor=0.5)
    jb, tb = _batch(tmodel.cfg)
    maps = []
    real = tmoe._permute
    monkeypatch.setattr(tmoe, "_permute", lambda x, f, b: maps.append((x.shape, f, b))
                        or real(x, f, b))
    jloss, _, jgrads = _jax_loss_and_grads(jmodel, jparams, jb, False)
    tloss, _, tgrads = _port_loss_and_grads(tmodel, tparams, tb, False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _grads_close(tgrads, jgrads, f"{arch} capacity 0.5", _grad_tol(tmodel.cfg))
    # the combine's maps: some slot was dropped (its destination is the pad)
    dropped = [b for shape, f, b in maps if b.shape[1] == shape[1] and bool((f == shape[1]).any())]
    assert maps and dropped
    # _permute's gradient, bit for bit, on every map the routing made
    rng = np.random.default_rng(4)
    for shape, fwd, bwd in maps:
        x = rng.standard_normal(shape).astype(np.float32)
        g = rng.standard_normal((shape[0], fwd.shape[1], shape[2])).astype(np.float32)
        g[:, ::3] = -0.0  # zero signs must survive
        xt = torch.from_numpy(x).requires_grad_()
        (dx,) = torch.autograd.grad(real(xt, fwd, bwd), xt, torch.from_numpy(g))
        m = fwd.shape[1]
        _, vjp = jax.vjp(lambda v: jmoe._permute(v, jnp.asarray(fwd.numpy()),
                                                 jnp.asarray(bwd.numpy()), m), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        assert np.array_equal(dx.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


# --- the train step ----------------------------------------------------------


def _dequantized(tree):
    return [np.asarray(leaf.q, np.float32) * np.asarray(leaf.scale)
            if isinstance(leaf, jadamw.QTensor) else np.asarray(leaf)
            for leaf in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jadamw.QTensor))]


def _moments_close(t_tree, j_tree, what):
    t_leaves, j_leaves = _tensors(t_tree), jax.tree.leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32)).max() <= 1
        else:
            _close(t, j, GRAD_TOL, what)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_microbatch", [1, 2])
@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_train_step_matches_the_reference(arch, n_microbatch, state_dtype):
    jmodel, jparams, tmodel, tparams = _models(arch)
    jcfg = jadamw.AdamWConfig(**ADAMW, state_dtype=state_dtype)
    tcfg = tadamw.AdamWConfig(**ADAMW, state_dtype=state_dtype)
    jstate = {"params": jparams, "opt": jadamw.init_opt_state(jparams, jcfg)}
    tstate = {"params": tparams, "opt": tadamw.init_opt_state(tparams, tcfg)}
    jstep = jax.jit(jsteps.make_train_step(jmodel, jcfg, n_microbatch=n_microbatch, remat=True))
    tstep = tsteps.make_train_step(tmodel, tcfg, n_microbatch=n_microbatch, remat=True)
    lr_sum, resolved = 0.0, None
    # the second f32 step starts from nonzero moments
    for seed in (1, 2) if state_dtype == "float32" else (1,):
        jb, tb = _batch(tmodel.cfg, seed=seed, b=4)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5, atol=1e-7)
        assert int(tm["step"]) == int(jm["step"]) == seed
        lr_sum = lr_sum + float(jm["lr"])
        want = jax.tree.leaves(jax.tree.map(np.asarray, jstate["params"]))
        now = [np.abs(m) >= GRAD_TOL * np.abs(m).max() for m in _dequantized(jstate["opt"]["m"])]
        resolved = now if resolved is None else [a & b for a, b in zip(resolved, now)]
        for got, w, ok in zip(tadamw.tree_leaves(tstate["params"]), want, resolved):
            err = np.abs(got.numpy() - w)
            tight = err <= LOSS_RTOL * np.abs(w) + LOSS_RTOL * np.abs(w).max() + 1e-2 * lr_sum
            assert tight[ok].all() and err.max() <= 2 * lr_sum, (w.shape, err.max())
        _moments_close(tstate["opt"]["m"], jstate["opt"]["m"], "m")
        _moments_close(tstate["opt"]["v"], jstate["opt"]["v"], "v")
    if n_microbatch > 1:
        assert float(tm["aux"]) == 0.0


# --- the per-layer AdamW update ----------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_per_layer_update_is_the_whole_leaf_update(state_dtype, monkeypatch):
    rng = np.random.default_rng(3)
    params = {"stack": rng.standard_normal((4, 6, 40)).astype(np.float32),
              "bias": rng.standard_normal(40).astype(np.float32),
              "embed": rng.standard_normal((30, 40)).astype(np.float32)}
    jcfg = jadamw.AdamWConfig(**ADAMW, state_dtype=state_dtype)
    tcfg = tadamw.AdamWConfig(**ADAMW, state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init_opt_state(jp, jcfg)
    states = {}
    for limit in (tadamw._SCAN_LIMIT, 100):  # whole leaves; then stack and embed per layer
        monkeypatch.setattr(tadamw, "_SCAN_LIMIT", limit)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = tadamw.init_opt_state(tp, tcfg)
        before = tadamw.update_per_layer.leaves
        for step in range(3):
            grads = {k: torch.from_numpy(np.random.default_rng(step).standard_normal(v.shape)
                                         .astype(np.float32)) for k, v in params.items()}
            tp, ts, _ = tadamw.adamw_update(tp, grads, ts, tcfg)
        assert tadamw.update_per_layer.leaves - before == (0 if limit > 100 else 2 * 3)
        states[limit] = (tp, ts)
    for step in range(3):
        grads = {k: jnp.asarray(np.random.default_rng(step).standard_normal(v.shape)
                                .astype(np.float32)) for k, v in params.items()}
        jp, js, _ = jadamw.adamw_update(jp, grads, js, jcfg)
    (whole_p, whole_s), (layer_p, layer_s) = states.values()
    for a, b in zip(_tensors([whole_p, whole_s]), _tensors([layer_p, layer_s])):
        assert torch.equal(a, b)
    for a, b in zip(tadamw.tree_leaves(layer_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(_tensors([layer_s["m"], layer_s["v"]]), jax.tree.leaves([js["m"], js["v"]])):
        if a.dtype == torch.int8:
            assert np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32)).max() <= 1
        else:
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def _tensors(tree):
    """The tensors of a tree, an int8 moment's ``q`` and ``scale`` apart."""
    out = []
    for leaf in tadamw.tree_leaves(tree):
        out.extend(leaf if isinstance(leaf, tadamw.QTensor) else [leaf])
    return out


# --- the trainer -------------------------------------------------------------


def _small(arch="olmo-1b"):
    return dict(n_layers=2, vocab=128) if arch == "olmo-1b" else {}


def test_trainer_history_matches_the_reference(capsys):
    jmodel, jparams, tmodel, tparams = _models("olmo-1b", **_small())
    dcfg = dict(vocab=128, seq_len=16, global_batch=4, seed=1)
    tcfg = dict(steps=6, log_every=1, n_microbatch=2, remat=True)
    jt = JTrainer(jmodel, jadamw.AdamWConfig(**ADAMW), JDataConfig(**dcfg),
                  JTrainerConfig(**tcfg))
    jt.run({"params": jparams, "opt": jadamw.init_opt_state(jparams, jadamw.AdamWConfig(**ADAMW))})
    tt = Trainer(tmodel, tadamw.AdamWConfig(**ADAMW), DataConfig(**dcfg), TrainerConfig(**tcfg),
                 device="cpu")
    opt = tadamw.init_opt_state(tparams, tadamw.AdamWConfig(**ADAMW))
    tt.run({"params": tparams, "opt": opt})
    assert [r["step"] for r in tt.history] == list(range(6))
    assert [sorted(r) for r in tt.history] == [sorted(r) for r in jt.history]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([r[key] for r in tt.history], [r[key] for r in jt.history],
                                   rtol=1e-4, err_msg=key)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed[-6:] == tt.history
    assert tt.history[-1]["loss"] < tt.history[0]["loss"]


@pytest.mark.parametrize("n_microbatch,remat", [(1, False), (2, True)])
def test_trainer_restart_is_bit_for_bit(tmp_path, n_microbatch, remat):
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), **_small())
    model = build_model(cfg)
    ocfg = tadamw.AdamWConfig(**ADAMW)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    tc = TrainerConfig(steps=6, log_every=100, n_microbatch=n_microbatch, remat=remat)
    straight = Trainer(model, ocfg, dcfg, tc, device="cpu").run()
    tc_mid = dataclasses.replace(tc, steps=3, checkpoint_every=100, checkpoint_dir=str(tmp_path))
    Trainer(model, ocfg, dcfg, tc_mid, device="cpu").run()  # saves step 2
    resumed = Trainer(model, ocfg, dcfg, dataclasses.replace(tc_mid, steps=6),
                      device="cpu").run()
    assert int(resumed["opt"]["step"]) == 6
    for a, b in zip(tadamw.tree_leaves(straight), tadamw.tree_leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launcher_runs_and_logs(capsys, tmp_path):
    launch_train.main(["--arch", "olmo-1b", "--smoke", "--steps", "4", "--batch", "4",
                       "--seq", "16", "--microbatch", "2", "--ckpt", str(tmp_path),
                       "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    cfg = get_config("olmo-1b").smoke()
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    assert out[0] == f"arch=olmo-1b-smoke params={n / 1e6:.1f}M"
    rows = [json.loads(line) for line in out[1:]]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
