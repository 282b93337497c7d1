"""The port's MoE, Mamba-2 and hybrid train steps on a mesh of gloo ranks,
against the JAX package.

The OLMo-1B cases of ``tests/test_torch_mesh.py`` for the other families,
with its worker (``tests/torch_mesh_worker.py``), its rules and its
tolerances: each case runs 4 ranks as separate processes under gloo on
the CPU (a fresh ``file://`` rendezvous each), the cases start together
when the module's fixture starts, and each test waits for the case it
reads.  The models are the ``smoke()`` configs of granite-moe-1b-a400m (4
experts top-2, 4 q heads over 2 kv heads), mamba2-370m (d_inner 128, 8
heads of 16, 160 conv channels) and jamba-1.5-large (16 layers: attention
1 : mamba 7, MoE every second layer), each with a vocab of 200, their
parameters drawn by the JAX package and carried across; the data is
``SyntheticLM`` (8 x 32 tokens, seed 0), 2 steps of 2 microbatches with
remat under ``sharding_ctx`` with ``param_shardings``.  The gradients'
tolerance grows with the depth as ``tests/test_torch_lm_train.py``'s does
(jamba's 16 layers: ``4e-4``; its SSM leaves' float32 gradients reach
1.5e-4 of their largest between two summation orders).  Jamba, and
granite where slots drop, take one step: a second step follows the sign
of first-step gradients within float32's rounding of zero (AdamW's sign
step moves such a weight by ``2 * lr`` either way).  Jamba's second-step
moments lie 0.5 of a leaf's largest apart between the port's own world-1
and mesh steps, where float64 holds them within 1e-5; where half the slots
drop, a route near a tie that such a weight moves changes which slots
drop after it.

The JAX package's sharded step runs the same cases in one subprocess per
model (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
``AxisType.Auto`` axes).  The checks:

* granite on ``(2, 2)`` and ``(1, 4)`` (one expert a rank; the 2 kv heads
  replicated over ``model`` while the 4 q heads split), and at
  ``capacity_factor=0.5`` (slots drop) on ``(2, 2)``; mamba2 on ``(2, 2)``
  and ``(1, 4)`` (160 conv channels, 40 a rank, against x's 32) and on
  ``(2, 2)`` under ``TRAIN_RULES_SP``; jamba on ``(2, 2)``: the metrics and
  the state against the JAX package's and the port's world-1 step by
  ``tests/test_torch_mesh.py``'s rules;
* every parameter placed by its spec, the JAX package's ``NamedSharding``
  spec, each rank's shard JAX's slice for its coordinate (the experts over
  ``model``, the Mamba leaves over their ``ssm_inner``/``ssm_heads``/
  ``ssm_conv_ch`` dims);
* one global batch's loss and aux on the mesh against world 1's, and each
  rank's top-k routes in every MoE layer (forward and rematerialised)
  equal to world 1's rows;
* a backward taken after the sharding context has closed (the card runs
  the rematerialised forward in another thread) gives the same bits;
* granite's and mamba2's checkpoints saved on ``(2, 2)`` restore bit for
  bit onto ``(1, 4)``, onto the 1x1 mesh of one rank and with no mesh;
* the aux loss is the product of the global batch's means, not the mean
  of the ranks' products;
* the SSD's gradient is finite where its masked upper triangle's exp
  overflows (mamba2-370m's chunk of 256 at full width), where the JAX
  package's is NaN.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import make_global_batch
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import params_from_arrays
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.train import make_train_step
from repro_torch.train.steps import loss_fn

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_mesh as M  # noqa: E402  (its rules, tolerances and reference helpers)
import torch_mesh_worker as W  # noqa: E402

GRANITE, MAMBA, JAMBA = "granite-moe-1b-a400m", "mamba2-370m", "jamba-1.5-large-398b"
MESH22 = dict(shape=[2, 2], axes=["data", "model"])
MESH14 = dict(shape=[1, 4], axes=["data", "model"])
CASES = {
    "granite_2x2": dict(MESH22, arch=GRANITE, rules="TRAIN_RULES", ckpt=True),
    "granite_1x4": dict(MESH14, arch=GRANITE, rules="TRAIN_RULES"),
    "granite_2x2_drop": dict(MESH22, arch=GRANITE, rules="TRAIN_RULES", steps=1,
                             overrides={"capacity_factor": 0.5}),
    "mamba2_2x2": dict(MESH22, arch=MAMBA, rules="TRAIN_RULES", ckpt=True),
    "mamba2_1x4": dict(MESH14, arch=MAMBA, rules="TRAIN_RULES"),
    "mamba2_2x2_sp": dict(MESH22, arch=MAMBA, rules="TRAIN_RULES_SP"),
    "jamba_2x2": dict(MESH22, arch=JAMBA, rules="TRAIN_RULES", steps=1),
}
CKPT_CASES = sorted(n for n, c in CASES.items() if c.get("ckpt"))

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs import ARCHS
from repro.data.pipeline import DataConfig, SyntheticLM, make_global_batch
from repro.models import build_model
from repro.models import params as P
from repro.optim.adamw import AdamWConfig, QTensor, init_opt_state
from repro.train.steps import make_train_step

params_path, out_path, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
VOCAB, B, S, MICRO, ADAMW = spec["vocab"], spec["batch"], spec["seq"], spec["micro"], spec["adamw"]


def nested(flat, template, prefix=""):
    if isinstance(template, dict):
        return {k: nested(flat, v, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    return flat[prefix]


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in paths(sub, f"{prefix}/{key}" if prefix else key).items()}
    if isinstance(tree, QTensor):
        return {f"{prefix}.q": tree.q, f"{prefix}.scale": tree.scale}
    return {prefix: tree}


def index_map(sharding, shape, mesh):
    by_dev = sharding.devices_indices_map(tuple(shape))
    out = {}
    for coord in np.ndindex(mesh.devices.shape):
        idx = by_dev[mesh.devices[coord]]
        out[",".join(map(str, coord))] = [
            [s.start or 0, shape[d] if s.stop is None else s.stop] for d, s in enumerate(idx)]
    return out


is_spec = lambda x: isinstance(x, PartitionSpec)
stream = SyntheticLM(DataConfig(vocab=VOCAB, seq_len=S, global_batch=B, seed=0))
arrays, meta = {}, {}
for case in spec["cases"]:
    name, shape = case["name"], tuple(case["shape"])
    cfg = dataclasses.replace(ARCHS[case["arch"]].smoke(), vocab=VOCAB, **case["overrides"])
    model = build_model(cfg)
    params0 = nested(dict(np.load(params_path)), model.abstract())
    mesh = jax.make_mesh(shape, tuple(case["axes"]), axis_types=(AxisType.Auto,) * len(shape))
    rules = getattr(P, case["rules"])
    ocfg = AdamWConfig(**ADAMW)
    with P.sharding_ctx(mesh, rules):
        specs = model.specs(rules, mesh)
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_spec)
        params = jax.device_put(params0, psh)
        state = {"params": params, "opt": init_opt_state(params, ocfg)}
        step = jax.jit(make_train_step(model, ocfg, n_microbatch=MICRO, remat=True,
                                       param_shardings=psh))
        bsh = NamedSharding(mesh, P.logical_spec((B, S), ("batch", None), rules, mesh))
        metrics = []
        for i in range(case["steps"]):
            state, m = step(state, make_global_batch(stream, i, mesh, {"tokens": bsh}))
            metrics.append({k: float(v) for k, v in m.items()})
            for key, leaf in paths(state).items():
                arrays[f"{name}/{i}/{key}"] = np.asarray(leaf)
    flat_sh = paths(psh)
    meta[name] = {
        "metrics": metrics,
        "specs": {k: [list(e) if isinstance(e, tuple) else e for e in tuple(v.spec)]
                  for k, v in flat_sh.items()},
        "index": {k: index_map(flat_sh[k], np.shape(v), mesh) for k, v in paths(params0).items()},
    }
np.savez(out_path, **arrays)
with open(out_path + ".json", "w") as f:
    json.dump(meta, f)
"""


def _arch_tag(arch):
    return arch.split("-")[0]


def _model(name):
    return W.case_model(CASES[name])


class Runs(M.Runs):
    """The cases' ranks and one JAX subprocess per model, started
    together."""

    def __init__(self, root: Path, params: dict):
        self.root, self.params, self.cache = root, params, {}
        self.jax_procs = {}
        for arch in sorted({c["arch"] for c in CASES.values()}):
            tag = _arch_tag(arch)
            cases = [dict(name=n, shape=c["shape"], axes=c["axes"], rules=c["rules"], arch=arch,
                          overrides=c.get("overrides", {}), steps=c.get("steps", W.STEPS))
                     for n, c in CASES.items() if c["arch"] == arch]
            spec = dict(vocab=W.VOCAB, batch=W.BATCH, seq=W.SEQ, micro=W.MICRO, adamw=W.ADAMW,
                        cases=cases)
            log = open(root / f"jax_{tag}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, "-c", REFERENCE, str(root / f"params_{tag}.npz"),
                 str(root / f"jax_{tag}.npz"), json.dumps(spec)], stdout=log,
                stderr=subprocess.STDOUT,
                env=M._env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                           JAX_PLATFORMS="cpu"))
            self.jax_procs[tag] = (proc, log)
        self.procs = {name: self._start(name, dict(
            case, kind="mesh", name=name, family=True,
            params=str(root / f"params_{_arch_tag(case['arch'])}.npz")), 4)
            for name, case in CASES.items()}

    def world1(self, name):
        key = f"world1_{name}"
        if key not in self.cache:
            self.get(name)
            self.procs[key] = self._start(key, dict(
                kind="world1", arch=CASES[name]["arch"], rules=CASES[name]["rules"],
                ckpt=str(self.root / name / "ck")), 1)
            self.cache[key] = self._wait(key)[0]
        return self.cache[key]

    def jax(self, name):
        tag = _arch_tag(CASES[name]["arch"])
        key = f"jax_{tag}"
        if key not in self.cache:
            proc, log = self.jax_procs[tag]
            try:
                proc.wait(timeout=M.TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            assert proc.returncode == 0, (self.root / f"{key}.log").read_text()[-4000:]
            meta = json.loads((self.root / f"{key}.npz.json").read_text())
            self.cache[key] = (dict(np.load(self.root / f"{key}.npz")), meta)
        return self.cache[key]

    def close(self):
        for _, procs, _ in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for proc, _ in self.jax_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_families")
    params = {}
    for arch in sorted({c["arch"] for c in CASES.values()}):
        jm = j_build_model(dataclasses.replace(J_ARCHS[arch].smoke(), vocab=W.VOCAB))
        params[arch] = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        np.savez(root / f"params_{_arch_tag(arch)}.npz", **W.paths(params[arch]))
    handle = Runs(root, params)
    yield handle
    handle.close()


@pytest.fixture(scope="module")
def world1(runs):
    """The port's world-1 steps of each case from the same parameters (the
    state's full tensors after each step and the metrics), and one global
    batch's loss, aux and routes."""
    out = {}
    for name, case in CASES.items():
        model, data = _model(name)
        params = params_from_arrays(runs.params[case["arch"]], device="cpu")
        opt = AdamWConfig(**W.ADAMW)
        step = make_train_step(model, opt, n_microbatch=W.MICRO, remat=True)
        state = {"params": params, "opt": tadamw.init_opt_state(params, opt)}
        steps = []
        for i in range(case.get("steps", W.STEPS)):
            state, m = step(state, make_global_batch(data, i, device="cpu"))
            steps.append(({k: v.numpy() for k, v in W.paths(state).items()},
                          {k: float(v) for k, v in m.items()}))
        with tmoe.record_routes() as routes:
            loss, parts = loss_fn(model, params, {"tokens": W.skewed_tokens(data)})
        out[name] = dict(steps=steps, loss=float(loss), aux=float(parts["aux"]),
                         routes=[r.numpy() for r in routes])
    return out


def _grad_tol(case):
    """``tests/test_torch_mesh.py``'s gradient tolerance at the depth rule
    of ``tests/test_torch_lm_train.py``: ``1e-4`` up to 4 layers, growing
    with the depth beyond (jamba's 16 layers: ``4e-4``)."""
    model, _ = _model(case)
    return M.GRAD_TOL * max(1.0, model.cfg.n_layers / 4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_step_matches_jax_and_world_1(runs, world1, case, monkeypatch):
    monkeypatch.setattr(M, "GRAD_TOL", _grad_tol(case))  # read by M's state rules
    jarrays, meta = runs.jax(case)
    rank0 = runs.get(case)[0]
    metrics = json.loads(str(rank0["f32_metrics"]))
    steps = CASES[case].get("steps", W.STEPS)
    assert len(metrics) == len(meta[case]["metrics"]) == steps
    resolved = M._resolved(jarrays, case, steps)
    lr_sum = 0.0
    for i in range(steps):
        lr_sum += meta[case]["metrics"][i]["lr"]
        got = M._rank_state(rank0, f"f32_{i}")
        M._metrics_close(metrics[i], meta[case]["metrics"][i], f"{case} step {i} vs jax")
        M._states_agree(got, M._jax_state(jarrays, case, i), resolved, lr_sum,
                        f"{case} step {i} vs jax")
        w1_state, w1_metrics = world1[case]["steps"][i]
        M._metrics_close(metrics[i], w1_metrics, f"{case} step {i} vs world 1")
        M._states_agree(got, w1_state, resolved, lr_sum, f"{case} step {i} vs world 1")


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_leaves_are_placed_as_the_jax_shardings(runs, case):
    _, meta = runs.jax(case)
    mesh = tparams.AbstractMesh(tuple(CASES[case]["shape"]), tuple(CASES[case]["axes"]))
    model, _ = _model(case)
    rules = getattr(tparams, CASES[case]["rules"])
    specs = W.paths(model.specs(rules, mesh))
    full = W.paths(runs.params[CASES[case]["arch"]])
    ranks = runs.get(case)
    assert all(bool(r["state_placements_ok"]) for r in ranks)
    for key, spec in specs.items():
        jspec = [tuple(e) if isinstance(e, list) else e for e in meta[case]["specs"][key]]
        assert tuple(spec) == tuple(jspec) + (None,) * (len(spec) - len(jspec)), (key, spec)
        want = str(tparams.placements(spec, mesh))
        for r in ranks:
            assert str(r[f"placements/{key}"]) == want, (case, key)
            coord = ",".join(map(str, r["coord"].tolist()))
            sl = tuple(slice(a, b) for a, b in meta[case]["index"][key][coord])
            np.testing.assert_array_equal(r[f"local/{key}"], full[key][sl], err_msg=key)
    # each rank holds E / model experts of every MoE layer, and the Mamba
    # leaves their inner channels / heads / conv channels over "model"
    m, on_model = CASES[case]["shape"][-1], len(CASES[case]["shape"]) - 1
    for key, d in W.paths(model.defs).items():
        dims = [i for i, a in enumerate(d.logical) if a == "experts" or str(a).startswith("ssm_")]
        for dim in dims:
            assert tparams.placements(specs[key], mesh)[on_model] == Shard(dim), (case, key)
            assert ranks[0][f"local/{key}"].shape[dim] == d.shape[dim] // m, (case, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_loss_aux_and_routes_match_world_1(runs, world1, case):
    ranks = runs.get(case)
    want = world1[case]
    for r in ranks:
        np.testing.assert_allclose(float(r["one/loss"]), want["loss"], rtol=M.RTOL)
        np.testing.assert_allclose(float(r["one/aux"]), want["aux"], rtol=M.RTOL)
        if not want["routes"]:
            assert r["one/routes"].size == 0
            continue
        rows = int(r["one/rows"])
        lo = int(r["coord"][0]) * rows  # the rank's rows of the global batch
        got = r["one/routes"]
        assert got.shape[0] == len(want["routes"])  # one record per MoE layer
        for layer, w in enumerate(want["routes"]):
            assert np.array_equal(got[layer], w[lo:lo + rows]), (case, layer)


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_remat_backward_outside_the_context(runs, case):
    """The rematerialised forward runs in the backward (on the card, in
    another thread): it re-enters the sharding context its forward ran in,
    so a backward taken after the context closed gives the same bits."""
    assert all(bool(r["remat/outside_equal"]) for r in runs.get(case))


@pytest.mark.parametrize("case", CKPT_CASES)
def test_family_checkpoint_restores_onto_1x4_and_world_1(runs, case):
    rank0 = runs.get(case)[0]
    steps = CASES[case].get("steps", W.STEPS)
    assert int(rank0["restore/1x4/step"]) == steps
    assert bool(rank0["restore/1x4/equal"]) and bool(rank0["restore/1x4/on_spec"])
    saved = M._rank_state(rank0, f"f32_{steps - 1}")
    one = runs.world1(case)
    assert int(one["step"]) == steps and bool(one["on_mesh"])
    model, _ = _model(case)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    template = {"params": params, "opt": tadamw.init_opt_state(params, AdamWConfig(**W.ADAMW))}
    plain, step = Checkpointer(runs.root / case / "ck").restore(template)
    assert step == steps
    plain = {k: v.numpy() for k, v in W.paths(plain).items()}
    assert plain.keys() == saved.keys()
    for key, want in saved.items():
        for got in (one[f"state/{key}"], plain[key]):
            assert got.dtype == want.dtype and np.array_equal(got, want), key


def test_mesh_aux_is_the_global_batch_aux(runs, world1):
    """The aux loss ``E * sum(me * ce)`` is a product of two means over the
    global batch: on the ``(2, 2)`` mesh it is the global batch's, where the
    mean of the two data ranks' own aux losses is another number (the
    second half of the batch one token repeated)."""
    case = "granite_2x2"
    model, data = _model(case)
    params = params_from_arrays(runs.params[GRANITE], device="cpu")
    tokens = W.skewed_tokens(data)
    half = tokens.shape[0] // 2
    per_rank = [float(loss_fn(model, params, {"tokens": t})[1]["aux"])
                for t in (tokens[:half], tokens[half:])]
    glob = world1[case]["aux"]
    assert abs(np.mean(per_rank) - glob) > 100 * M.RTOL * glob  # another number
    for r in runs.get(case):
        np.testing.assert_allclose(float(r["one/aux"]), glob, rtol=M.RTOL)


def test_ssd_gradient_is_finite_where_the_upper_triangle_overflows():
    """mamba2-370m's chunk of 256 at full width: a cumulative decay of
    hundreds, whose exp in the (masked) upper triangle overflows float32.
    The port masks before the exp: the same values as the JAX package's
    scan, and finite gradients within float32 rounding of the float64 ones,
    where the JAX package's ``where(tri, exp(diff), 0)`` gives NaN."""
    from repro.models.ssm import ssd_chunked as j_ssd
    from repro_torch.models.ssm import ssd_chunked

    g = np.random.default_rng(0)
    B, S, nh, hp, n = 1, 256, 2, 4, 4
    arrays = (g.standard_normal((B, S, nh, hp)).astype(np.float32),
              np.full((B, S, nh), 0.08, np.float32), np.array([-16.0, -1.0], np.float32),
              g.standard_normal((B, S, n)).astype(np.float32),
              g.standard_normal((B, S, n)).astype(np.float32))

    def port(dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
        y, _ = ssd_chunked(*ts, 256)
        y.sum().backward()
        return y.detach().double().numpy(), [t.grad.double().numpy() for t in ts]

    # a difference of two cumulative sums near 300 keeps float32's ~3e-5 of
    # their size: the gradients' tolerance, not the loss's
    (y32, g32), (y64, g64) = port(torch.float32), port(torch.float64)
    jy = np.asarray(j_ssd(*map(jax.numpy.asarray, arrays), 256)[0])
    for want in (jy, y64):
        np.testing.assert_allclose(y32, want, rtol=M.GRAD_TOL, atol=M.GRAD_TOL * np.abs(want).max())
    jgrads = jax.grad(lambda *a: j_ssd(*a, 256)[0].sum(), argnums=(1, 2))(
        *map(jax.numpy.asarray, arrays))
    assert not all(np.isfinite(np.asarray(a)).all() for a in jgrads)  # the reference's NaN
    for got, want in zip(g32, g64):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=M.GRAD_TOL, atol=M.GRAD_TOL * np.abs(want).max())
