"""The port's sharding surfaces against the JAX package's, on the CPU.

* The rule tables, and for every arch at full width on the meshes
  ``(1, 1)``, ``(16, 16)`` and ``(2, 16, 16)`` (``jax.sharding.AbstractMesh``
  against the port's ``AbstractMesh`` of the same shape): the parameter
  specs, the moments' specs (f32 and int8), the decode cache's specs at
  every shape's batch and length, and the inputs of every cell (shapes,
  dtypes apart from the token ids: int32 there, int64 here, and their
  batch specs).  A ``PartitionSpec`` is compared as ``tuple(P)``.
* The dry run's rules: ``default_microbatch``, ``needs_sp``,
  ``opt_config`` and ``cell_applicable`` over every (arch × shape × mesh)
  at a spec of 16e9 bytes, which gives the JAX package's budgets.
* ``shard``/``constrain_defs``: identities outside a context and, for a
  plain tensor, on a mesh of one device; a plain tensor inside a context
  on a larger mesh raises ``TypeError`` (it was never placed).
* ``make_train_step(param_shardings=)``, ``make_global_batch(mesh=,
  sharding=)`` and ``Checkpointer.restore(shardings=)`` on the 1x1 CPU
  mesh (a world-1 gloo group in this process) are bit for bit the calls
  without them.
* The same surfaces on a mesh of 2 ranks: ``tests/torch_mesh_worker.py``
  (``surfaces``) as 2 processes under gloo on the CPU, joined through a
  fresh ``file://`` rendezvous, each within ``TIMEOUT_S``; the batch over
  ``data`` on ``(2, 1)``, the weights over ``model`` on ``(1, 2)``.
  ``shard``/``constrain_defs`` redistribute a DTensor to its spec; the
  batch's rows are each rank's and its ``full_tensor()`` the batch without
  a mesh; the train step agrees with the step without a mesh (loss and
  grad norm within ``1e-5``, every leaf within ``2 * lr`` a step and
  ``1e-5`` of the rest); a checkpoint restores onto either mesh bit for
  bit.  ``tests/test_torch_mesh.py`` holds the 4-rank step against the
  JAX package's.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # both frameworks in one process, JAX on the CPU
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor
from jax.sharding import AbstractMesh as JMesh

import repro.models as jmodels
import repro.models.params as jparams
import repro.optim.adamw as jadamw
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES, get_config as jget
from repro_torch.analysis.roofline import HardwareSpec
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.models import params as tparams
from repro_torch.models import build_model, input_specs
from repro_torch.optim import AdamWConfig, opt_state_specs
from repro_torch.optim.adamw import QTensor

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
RULES = ("TRAIN_RULES", "TRAIN_RULES_SP", "DECODE_RULES")
# a device of 16e9 bytes: the budgets of the JAX package's dry run
SPEC16 = HardwareSpec("test_16e9", 1e12, 1e12, 1e11, 16e9, 1e12)
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
TIMEOUT_S = 180  # per rank process


def _meshes(name):
    sizes, names = MESHES[name]
    return JMesh(sizes, names), tparams.AbstractMesh(sizes, names)


def _specs(tree):
    """A spec tree as plain data: dicts, ``(q, scale)`` for a QTensor and
    tuples for a ``PartitionSpec`` (JAX) or a spec (the port)."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (jadamw.QTensor, QTensor)):
        return ("qtensor", _specs(tree[0]), _specs(tree[1]))
    return tuple(tree)


def test_rule_tables_match_jax():
    assert jparams.TRAIN_RULES.table["seq"] is None
    for name in RULES:
        j, t = getattr(jparams, name), getattr(tparams, name)
        assert (t.name, t.table) == (j.name, j.table), name
        for logical in list(j.table) + [None, "no-such-axis"]:
            assert t.get(logical) == j.get(logical)


def test_logical_spec_fallbacks_match_jax():
    """Absent axes, axes used twice and axes that do not divide fall back."""
    cases = [((64, 48), ("embed", "mlp")), ((56, 128), ("heads", None)),
             ((8, 4096), ("batch", "seq")), ((1, 16), ("batch", "embed")),
             ((32, 32), ("vocab", "heads")), ((96, 8, 128), ("embed", "kv_heads", None))]
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for name in RULES:
            jr, tr = getattr(jparams, name), getattr(tparams, name)
            for shape, logical in cases:
                assert tparams.logical_spec(shape, logical, tr, tm) == tuple(
                    jparams.logical_spec(shape, logical, jr, jm)), (mesh, name, shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_jax(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    jm_model, tm_model = jmodels.build_model(jget(arch)), build_model(get_config(arch))
    jabs, tabs = jm_model.abstract(), tm_model.abstract()
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for name in RULES:
            jr, tr = getattr(jparams, name), getattr(tparams, name)
            jp, tp = jm_model.specs(jr, jm), tm_model.specs(tr, tm)
            assert _specs(tp) == _specs(jp), (mesh, name)
            for dtype in ("float32", "int8"):
                jo = jadamw.opt_state_specs(jabs, jp, jadamw.AdamWConfig(state_dtype=dtype), jm)
                to = opt_state_specs(tabs, tp, AdamWConfig(state_dtype=dtype), tm)
                assert _specs(to) == _specs(jo), (mesh, name, dtype)
        jr, tr = jparams.DECODE_RULES, tparams.DECODE_RULES
        for shape in SHAPES.values():
            B, S = shape.global_batch, shape.seq_len
            assert _specs(tm_model.cache_specs(tr, tm, B, S)) == _specs(
                jm_model.cache_specs(jr, jm, B, S)), (mesh, shape.name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_trees_match_jax(arch):
    """Parameters, caches and inputs: the same keys, shapes and dtypes
    (token ids apart), on ``meta`` without allocating."""
    jm_model, tm_model = jmodels.build_model(jget(arch)), build_model(get_config(arch))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    def meta(tree):
        return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."), v.device.type)
                for k, v in flat(tree).items()}

    def jx(tree):
        return {k: (tuple(v.shape), str(v.dtype), "meta") for k, v in flat(tree).items()}

    assert meta(tm_model.abstract()) == jx(jm_model.abstract())
    assert meta(tparams.abstract_params(tm_model.defs, torch.float32)) == jx(
        jparams.abstract_params(jm_model.defs, jax.numpy.float32))
    assert meta(tm_model.abstract_cache(2, 64)) == jx(jm_model.abstract_cache(2, 64))
    jm, tm = _meshes("2x16x16")
    for shape in SHAPES.values():
        ji, ti = jmodels.input_specs(jget(arch), JSHAPES[shape.name]), input_specs(
            get_config(arch), shape)
        assert ti["tokens"].dtype == torch.int64 and ji["tokens"].dtype == jax.numpy.int32
        want = jx(ji)
        want["/tokens"] = want["/tokens"][:1] + ("int64", "meta")
        assert meta(ti) == want, shape.name
        for k, v in ti.items():
            logical = ("batch",) + (None,) * (v.dim() - 1)
            for r in RULES:
                assert tparams.logical_spec(tuple(v.shape), logical, getattr(tparams, r), tm) \
                    == tuple(jparams.logical_spec(ji[k].shape, logical, getattr(jparams, r), jm))


@pytest.fixture(scope="module")
def jdryrun():
    """The JAX package's dry-run module.  Importing it sets XLA_FLAGS to a
    512-device count for the rest of the process; JAX's backend is started
    first (its device count is then fixed) and the variable restored, so
    that no later subprocess of this worker inherits it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_the_fixture_restores_xla_flags(jdryrun):
    assert "device_count=512" not in os.environ.get("XLA_FLAGS", "")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dryrun_rules_match_jax(jdryrun, mesh):
    from repro_torch.launch import dryrun as tdryrun

    jm, tm = _meshes(mesh)
    for arch in sorted(ARCHS):
        jcfg, tcfg = jget(arch), get_config(arch)
        assert dataclasses.asdict(tdryrun.opt_config(tcfg)) == dataclasses.asdict(
            jdryrun.opt_config(jcfg))
        for name in SHAPES:
            js, ts = JSHAPES[name], SHAPES[name]
            assert tdryrun.default_microbatch(tcfg, ts, tm, SPEC16) == \
                jdryrun.default_microbatch(jcfg, js, jm), (arch, name)
            assert tdryrun.needs_sp(tcfg, ts, tm, SPEC16) == jdryrun.needs_sp(jcfg, js, jm)
            assert tdryrun.cell_applicable(tcfg, ts) == jdryrun.cell_applicable(jcfg, js)
        for k in (1, 2):
            assert dataclasses.asdict(tdryrun.unrolled_cfg(tcfg, k)) == dataclasses.asdict(
                jdryrun.unrolled_cfg(jcfg, k))


def test_dryrun_budgets_scale_with_the_card(jdryrun):
    """On the card's 80e9 bytes the budgets are five times 16e9's: fewer
    microbatches, and sequence parallelism nowhere."""
    from repro_torch.analysis.roofline import H100_SXM
    from repro_torch.launch import dryrun as tdryrun

    _, tm = _meshes("16x16")
    shape = SHAPES["train_4k"]
    pairs = [(tdryrun.default_microbatch(get_config(a), shape, tm, SPEC16),
              tdryrun.default_microbatch(get_config(a), shape, tm, H100_SXM)) for a in ARCHS]
    assert all(card <= small for small, card in pairs) and any(c < s for s, c in pairs)
    assert any(tdryrun.needs_sp(get_config(a), shape, tm, SPEC16) for a in ARCHS)
    assert not any(tdryrun.needs_sp(get_config(a), shape, tm, H100_SXM) for a in ARCHS)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The ``surfaces`` case of ``tests/torch_mesh_worker.py`` on 2 gloo
    ranks: each rank's results."""
    out = tmp_path_factory.mktemp("two_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    case = json.dumps({"kind": "surfaces"})
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), "2",
                               f"file://{out / 'rendezvous'}", str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode()[-4000:])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0].decode()[-4000:])
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_shard_and_constrain_defs_raise_on_more_than_one_device(two_ranks):
    """Identities outside a context; inside one, a plain tensor passes on a
    mesh of one device and raises on a larger one, and a DTensor is
    redistributed to its spec (2 ranks)."""
    x = torch.ones(4, 8)
    defs = {"w": tparams.ParamDef((4, 8), ("embed", "mlp"))}
    assert tparams.get_sharding_ctx() is None
    assert tparams.shard(x, "batch", None) is x
    assert tparams.constrain_defs({"w": x}, defs)["w"] is x
    one, big = tparams.AbstractMesh((1, 1), ("data", "model")), _meshes("16x16")[1]
    with tparams.sharding_ctx(one, tparams.TRAIN_RULES):
        assert tparams.get_sharding_ctx() == (one, tparams.TRAIN_RULES)
        assert tparams.shard(x, "batch", None) is x
        assert tparams.constrain_defs({"w": x}, defs)["w"] is x
    with tparams.sharding_ctx(big, tparams.TRAIN_RULES):
        with pytest.raises(TypeError, match="256 devices"):
            tparams.shard(x, "batch", None)
        with pytest.raises(TypeError, match="never placed|place the inputs"):
            tparams.constrain_defs({"w": x}, defs)
    assert tparams.get_sharding_ctx() is None
    for r in two_ranks:
        assert bool(r["plain_raises"])
        # ("batch", "mlp") and ("embed", "mlp") on (1, 2): dim 1 over "model"
        assert str(r["shard/placements"]) == "(Replicate(), Shard(dim=1))"
        assert str(r["constrain/placements"]) == "(Replicate(), Shard(dim=1))"
        assert bool(r["shard/equal"]) and bool(r["constrain/equal"])


# --- the sharding arguments on the 1x1 CPU mesh ------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _small_model():
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=2, vocab=128)
    return build_model(cfg)


def test_host_mesh_is_one_by_one(host_mesh):
    from repro_torch.launch import mesh as tmesh

    assert tparams.mesh_shape(host_mesh) == {"data": 1, "model": 1}
    assert host_mesh.device_type == "cpu"
    assert list(tmesh.mesh_devices(1)) == [0]
    with pytest.raises(RuntimeError, match="mesh needs 256 ranks, found 1"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="mesh needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def _named(model, mesh):
    specs = model.specs(tparams.TRAIN_RULES, mesh)
    return tparams.tree_map(lambda s: tparams.NamedSharding(mesh, s), specs)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def test_train_step_param_shardings_bit_for_bit(host_mesh, two_ranks):
    from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
    from repro_torch.optim.adamw import init_opt_state, tree_leaves
    from repro_torch.train import init_train_state, make_train_step

    model = _small_model()
    opt = AdamWConfig(lr_peak=1e-2, warmup_steps=1)
    data = SyntheticLM(DataConfig(vocab=128, seq_len=8, global_batch=4, seed=1))
    outs = []
    for shardings in (None, _named(model, host_mesh)):
        state = init_train_state(model, torch.Generator().manual_seed(0), opt, device="cpu")
        batch = make_global_batch(data, 0, device="cpu")
        if shardings is not None:  # the state and the batch on the 1x1 mesh
            params = tparams.tree_map(tparams.place, state["params"], shardings)
            state = {"params": params, "opt": init_opt_state(params, opt)}
            batch = make_global_batch(data, 0, mesh=host_mesh)
        step = make_train_step(model, opt, n_microbatch=2, param_shardings=shardings)
        with tparams.sharding_ctx(host_mesh, tparams.TRAIN_RULES):
            for _ in range(2):
                state, metrics = step(state, batch)
        outs.append((state, metrics))

    (a, ma), (b, mb) = outs
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, _full(y))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)

    # 2 ranks: the batch over data, then the weights over model, against
    # the same 2 steps without a mesh
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": init_opt_state(params, opt)}
    step = make_train_step(model, opt, n_microbatch=2)
    want, resolved = [], {}
    for i in range(2):
        state, metrics = step(state, make_global_batch(data, i, device="cpu"))
        want.append({k: float(v) for k, v in metrics.items()})
        for key, m in _paths(state["opt"]["m"]).items():  # resolved at every step
            now = (m.abs() >= 1e-4 * m.abs().max()).numpy()
            resolved[key] = now if key not in resolved else resolved[key] & now
    lr_sum = sum(m["lr"] for m in want)
    flat = _paths(state)
    for tag in ("data", "model"):
        got = json.loads(str(two_ranks[0][f"step/{tag}/metrics"]))
        for g, w in zip(got, want):
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=(tag, key))
        for key, w in flat.items():
            g, w = two_ranks[0][f"step/{tag}/{key}"], w.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, (tag, key)
            if key.startswith("params/"):
                # tests/test_torch_mesh.py's resolved-gradient rule: tight
                # where the gradient was resolved at both steps, within
                # AdamW's sign step (2 * lr a step) elsewhere
                err = np.abs(g.astype(np.float64) - w)
                tight = err <= 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max() + 1e-2 * lr_sum
                ok = resolved[key[len("params/"):]]
                assert ok.any() and tight[ok].all(), (tag, key, err[ok].max())
                assert err.max() <= 2 * lr_sum, (tag, key, err.max())
            elif key == "opt/step":
                assert int(g) == int(w)
            else:  # the moments, within the gradients' tolerance
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                           err_msg=f"{tag} {key}")


def _paths(tree, prefix=""):
    """``{"a/b": leaf}`` of a state tree (int8 moments as ``.q``/``.scale``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{prefix}/{key}" if prefix else key).items()}
    if isinstance(tree, QTensor):
        return {f"{prefix}.q": tree.q, f"{prefix}.scale": tree.scale}
    return {prefix: tree}


def test_global_batch_on_the_mesh_bit_for_bit(host_mesh, two_ranks):
    from repro_torch.data import DataConfig, SyntheticLM, make_global_batch

    data = SyntheticLM(DataConfig(vocab=128, seq_len=8, global_batch=4, seed=2))
    plain = make_global_batch(data, 3, device="cpu")
    on_mesh = make_global_batch(data, 3, mesh=host_mesh)
    spec = tparams.logical_spec((4, 8), ("batch", None), tparams.TRAIN_RULES, host_mesh)
    sharded = make_global_batch(data, 3, sharding={
        "tokens": tparams.NamedSharding(host_mesh, spec)})
    for got in (on_mesh, sharded):
        assert got.keys() == plain.keys()
        assert isinstance(got["tokens"], DTensor)
        assert torch.equal(got["tokens"].full_tensor(), plain["tokens"])
        assert torch.equal(got["tokens"].to_local(), plain["tokens"])
        assert got["tokens"].device == torch.device("cpu")
    # 2 ranks over "data": rows [0, 2) and [2, 4), the global batch's
    want = data.batch_at(3)["tokens"]
    for r in two_ranks:
        lo = 2 * int(r["coord"][0])
        for tag in ("mesh", "sharding"):
            assert np.array_equal(r[f"batch/{tag}/local"], want[lo:lo + 2])
            assert np.array_equal(r[f"batch/{tag}/full"], plain["tokens"].numpy())


def test_checkpoint_restore_with_shardings_bit_for_bit(host_mesh, tmp_path, two_ranks):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim.adamw import init_opt_state, tree_leaves

    model = _small_model()
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    for dtype in ("float32", "int8"):
        cfg = AdamWConfig(state_dtype=dtype)
        state = {"params": params, "opt": init_opt_state(params, cfg)}
        ck = Checkpointer(tmp_path / dtype)
        ck.save(5, state, blocking=True)
        pspecs = model.specs(tparams.TRAIN_RULES, host_mesh)
        specs = {"params": pspecs,
                 "opt": opt_state_specs(model.abstract(), pspecs, cfg, host_mesh)}

        def named(tree):
            if isinstance(tree, dict):
                return {k: named(v) for k, v in tree.items()}
            if isinstance(tree, QTensor):
                return QTensor(*(tparams.NamedSharding(host_mesh, s) for s in tree))
            return tparams.NamedSharding(host_mesh, tree)

        plain, step = ck.restore(state)
        sharded, step2 = ck.restore(state, shardings=named(specs))
        assert step == step2 == 5
        flat = lambda tree: [t for leaf in tree_leaves(tree)  # noqa: E731
                             for t in (leaf if isinstance(leaf, QTensor) else (leaf,))]
        assert len(flat(plain)) == len(flat(state))
        for x, y in zip(flat(plain), flat(sharded)):
            assert isinstance(y, DTensor)
            assert torch.equal(x, y.full_tensor()) and x.dtype == y.dtype
    # 2 ranks: an int8 state restored onto (2, 1) and (1, 2), bit for bit
    for r in two_ranks:
        for tag in ("data", "model"):
            assert int(r[f"restore/{tag}/step"]) == 5 and bool(r[f"restore/{tag}/equal"])


def test_placing_on_an_abstract_mesh_is_refused():
    one = tparams.AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="no devices"):
        tparams.place(torch.ones(2), tparams.NamedSharding(one, (None,)))
    with pytest.raises(ValueError, match="sizes"):
        tparams.AbstractMesh((1, 1), ("data",))
