"""The port's OLMo-1B train step on a mesh of gloo ranks, against the JAX package.

Each case runs 4 ranks of ``tests/torch_mesh_worker.py`` as separate
processes under gloo on the CPU, joined through a fresh ``file://``
rendezvous (no TCP port, so parallel test workers cannot collide), each
process bounded by its own timeout; the cases start together when the
module's fixture starts, and each test waits for the case it reads.  The
model is OLMo-1B's ``smoke()`` config with a vocab of 200 (padded to 256,
so the padded-vocab mask runs), its parameters drawn by the JAX package
and carried across with ``params_from_arrays``; the data is
``SyntheticLM`` (8 x 32 tokens, seed 0).  The step: 2 steps of 2
microbatches with remat under ``sharding_ctx`` with ``param_shardings``.

The JAX package's step runs on the same mesh shapes in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, ``jax.make_mesh``
with ``AxisType.Auto`` axes).  The checks:

* meshes ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` over ``("data", "model")``
  and ``(2, 2, 1)`` over ``("pod", "data", "model")`` under
  ``TRAIN_RULES``, and ``(2, 2)`` under ``TRAIN_RULES_SP``: loss, ce, grad
  norm and lr within ``rtol=1e-5`` of the JAX package's and of the port's
  world-1 step, with ``tests/test_torch_lm_train.py``'s rules for the
  one-device step: the moments within the gradients' tolerance
  (``rtol=1e-4, atol=1e-4 * max|leaf|``: the two sum in different orders,
  and a first moment is 0.1 of a clipped gradient, ~1e-5 here, so an
  absolute tolerance would be vacuous); the parameters within ``rtol=1e-5``
  plus ``1e-5 * max|leaf| + 1e-2 * lr`` wherever the gradient was resolved
  at every step, and everywhere within ``2 * lr`` a step (AdamW's first
  steps move a weight by ``lr * sign(g)``, and the sign of a gradient
  within its rounding of zero may go either way);
* every parameter's placements are ``placements`` of its spec, the spec is
  the JAX package's ``NamedSharding`` spec, and each rank's shard is the
  slice that JAX's ``devices_indices_map`` gives the device at the rank's
  mesh coordinate;
* each rank's rows of ``make_global_batch(mesh=)`` and ``(sharding=)`` are
  the JAX batch sharding's slice, and ``full_tensor()`` is bit for bit the
  batch without a mesh;
* int8 moments, one step, against the JAX package's; the int8 scale of a
  row sharded over ``model`` is the global row's (bit for bit);
* the blockwise attention (four query chunks, two key chunks) with heads
  over ``model`` and batch over ``data``, forward and gradients, within
  ``1e-5`` of the plain one;
* a checkpoint saved on ``(2, 2)`` restores bit for bit onto ``(4, 1)``,
  ``(1, 4)``, the 1x1 mesh of one rank and no mesh; a JAX checkpoint
  restores onto ``(2, 2)`` bit for bit;
* the c10d all-gather route (forced on the CPU; gloo on the card takes it)
  gives the same bits as the functional one;
* the masked-sum cross-entropy is bit for bit the gather's on one device
  and within ``1e-5`` of the JAX package's loss.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.optim.adamw as jadamw
import repro.train.steps as jsteps
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import make_global_batch
from repro_torch.models import build_model, params_from_arrays
from repro_torch.models import layers as tlayers
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.train import make_train_step
from repro_torch.train import steps as tsteps

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
sys.path.insert(0, str(WORKER.parent))
import torch_mesh_worker as W  # noqa: E402  (the ranks' constants and tree helpers)

TIMEOUT_S = 240  # per process; a hung rank fails its case, not the suite
RTOL, GRAD_TOL = 1e-5, 1e-4
CASES = {
    "2x2": dict(shape=[2, 2], axes=["data", "model"], rules="TRAIN_RULES", extra=True),
    "4x1": dict(shape=[4, 1], axes=["data", "model"], rules="TRAIN_RULES"),
    "1x4": dict(shape=[1, 4], axes=["data", "model"], rules="TRAIN_RULES"),
    "2x2x1": dict(shape=[2, 2, 1], axes=["pod", "data", "model"], rules="TRAIN_RULES"),
    "2x2_sp": dict(shape=[2, 2], axes=["data", "model"], rules="TRAIN_RULES_SP"),
}

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
cfg = dataclasses.replace(ARCHS["olmo-1b"].smoke(), vocab=VOCAB)
model = build_model(cfg)
params0 = nested(dict(np.load(params_path)), model.abstract())
stream = SyntheticLM(DataConfig(vocab=VOCAB, seq_len=S, global_batch=B, seed=0))
arrays, meta = {}, {}
for case in spec["cases"]:
    name, shape = case["name"], tuple(case["shape"])
    mesh = jax.make_mesh(shape, tuple(case["axes"]), axis_types=(AxisType.Auto,) * len(shape))
    rules = getattr(P, case["rules"])
    ocfg = AdamWConfig(**ADAMW, state_dtype=case["state_dtype"])
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
        "batch_index": index_map(bsh, (B, S), mesh),
    }
np.savez(out_path, **arrays)
with open(out_path + ".json", "w") as f:
    json.dump(meta, f)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def _jax_model():
    return j_build_model(dataclasses.replace(J_ARCHS["olmo-1b"].smoke(), vocab=W.VOCAB))


class Runs:
    """The cases' processes, started together; each result is read once
    its processes have ended (each within ``TIMEOUT_S``)."""

    def __init__(self, root: Path, params: dict):
        self.root, self.params, self.cache = root, params, {}
        cases = [dict(name=n, shape=c["shape"], axes=c["axes"], rules=c["rules"],
                      state_dtype="float32", steps=W.STEPS) for n, c in CASES.items()]
        cases.append(dict(name="2x2_int8", shape=[2, 2], axes=["data", "model"],
                          rules="TRAIN_RULES", state_dtype="int8", steps=1))
        spec = dict(vocab=W.VOCAB, batch=W.BATCH, seq=W.SEQ, micro=W.MICRO, adamw=W.ADAMW,
                    cases=cases)
        self.jax_out = root / "jax.npz"
        self.jax_log = open(root / "jax.log", "w")
        self.jax_proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, str(root / "params.npz"), str(self.jax_out),
             json.dumps(spec)], stdout=self.jax_log, stderr=subprocess.STDOUT,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"))
        self.procs = {name: self._start(name, dict(case, kind="mesh", name=name,
                                                   params=str(root / "params.npz"),
                                                   jax_ckpt=str(root / "jax_ckpt")), 4)
                      for name, case in CASES.items()}

    def _start(self, name, case, world):
        d = self.root / name
        d.mkdir()
        init = f"file://{d / 'rendezvous'}"
        logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), json.dumps(case), str(r), str(world), init, str(d)],
            stdout=logs[r], stderr=subprocess.STDOUT, env=_env()) for r in range(world)]
        return d, procs, logs

    def _wait(self, name):
        d, procs, logs = self.procs[name]
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        for r, p in enumerate(procs):
            tail = (d / f"rank{r}.log").read_text()[-4000:]
            assert p.returncode == 0, f"{name} rank {r} exited {p.returncode}:\n{tail}"
        return [dict(np.load(d / f"rank{r}.npz")) for r in range(len(procs))]

    def get(self, name):
        if name not in self.cache:
            self.cache[name] = self._wait(name)
        return self.cache[name]

    def world1(self):
        if "world1" not in self.cache:
            self.get("2x2")
            self.procs["world1"] = self._start("world1", dict(
                kind="world1", rules="TRAIN_RULES", ckpt=str(self.root / "2x2" / "ck22")), 1)
            self.cache["world1"] = self._wait("world1")[0]
        return self.cache["world1"]

    def jax(self):
        if "jax" not in self.cache:
            try:
                self.jax_proc.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.jax_proc.kill()
                self.jax_proc.wait()
            self.jax_log.close()
            assert self.jax_proc.returncode == 0, (self.root / "jax.log").read_text()[-4000:]
            meta = json.loads(Path(str(self.jax_out) + ".json").read_text())
            self.cache["jax"] = (dict(np.load(self.jax_out)), meta)
        return self.cache["jax"]

    def close(self):
        for _, procs, _ in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if self.jax_proc.poll() is None:
            self.jax_proc.kill()
            self.jax_proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    jparams = jax.tree.map(np.asarray, _jax_model().init(jax.random.key(0)))
    np.savez(root / "params.npz", **W.paths(jparams))
    opt = jadamw.AdamWConfig(**W.ADAMW)
    JCheckpointer(root / "jax_ckpt").save(
        0, {"params": jparams, "opt": jadamw.init_opt_state(jparams, opt)}, blocking=True)
    handle = Runs(root, jparams)
    yield handle
    handle.close()


@pytest.fixture(scope="module")
def world1_states(runs):
    """The port's world-1 step from the same parameters: the state's full
    tensors after each step, and the metrics."""
    model, data = W.model_and_data()
    params = params_from_arrays(runs.params, device="cpu")
    out = {}
    for dtype, steps in (("float32", W.STEPS), ("int8", 1)):
        opt = AdamWConfig(**W.ADAMW, state_dtype=dtype)
        step = make_train_step(model, opt, n_microbatch=W.MICRO, remat=True)
        state = {"params": params, "opt": tadamw.init_opt_state(params, opt)}
        for i in range(steps):
            state, m = step(state, make_global_batch(data, i, device="cpu"))
            out[dtype, i] = ({k: v.numpy() for k, v in W.paths(state).items()},
                             {k: float(v) for k, v in m.items()})
    return out


def _states_agree(got, want, resolved_from, lr_sum, what):
    """The parameters by the resolved-gradient rule, the moments within
    the gradients' tolerance ``rtol=GRAD_TOL, atol=GRAD_TOL * max|leaf|``
    (int8: ``q`` within one step)."""
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, key, g.dtype, w.dtype)
        if key.startswith("params/"):
            err = np.abs(g.astype(np.float64) - w)
            tight = err <= RTOL * np.abs(w) + RTOL * np.abs(w).max() + 1e-2 * lr_sum
            ok = resolved_from[key]
            assert tight[ok].all() and err.max() <= 2 * lr_sum, (what, key, err.max())
        elif key.endswith(".q"):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, (what, key)
        elif key != "opt/step":
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(),
                                       err_msg=f"{what} {key}")
        else:
            assert int(g) == int(w)


def _resolved(jarrays, name, steps):
    """Per parameter, where its JAX first moment is at least ``GRAD_TOL``
    of its largest at every step (the gradient is resolved there)."""
    out = {}
    for i in range(steps):
        for key in [k[len(f"{name}/{i}/"):] for k in jarrays if k.startswith(f"{name}/{i}/params/")]:
            m = jarrays[f"{name}/{i}/opt/m/{key[len('params/'):]}"]
            now = np.abs(m) >= GRAD_TOL * np.abs(m).max()
            out[key] = now if key not in out else out[key] & now
    return out


def _jax_state(jarrays, name, i):
    prefix = f"{name}/{i}/"
    return {k[len(prefix):]: v for k, v in jarrays.items() if k.startswith(prefix)}


def _rank_state(rank0, tag):
    prefix = f"{tag}/"
    return {k[len(prefix):]: v for k, v in rank0.items() if k.startswith(prefix)}


def _metrics_close(got, want, what):
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=f"{what} {key}")
    assert got["step"] == want["step"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_matches_jax_and_world_1(runs, world1_states, case):
    jarrays, meta = runs.jax()
    rank0 = runs.get(case)[0]
    metrics = json.loads(str(rank0["f32_metrics"]))
    resolved = _resolved(jarrays, case, W.STEPS)
    lr_sum = 0.0
    for i in range(W.STEPS):
        lr_sum += meta[case]["metrics"][i]["lr"]
        got = _rank_state(rank0, f"f32_{i}")
        _metrics_close(metrics[i], meta[case]["metrics"][i], f"{case} step {i} vs jax")
        _states_agree(got, _jax_state(jarrays, case, i), resolved, lr_sum,
                      f"{case} step {i} vs jax")
        w1_state, w1_metrics = world1_states["float32", i]
        _metrics_close(metrics[i], w1_metrics, f"{case} step {i} vs world 1")
        _states_agree(got, w1_state, resolved, lr_sum, f"{case} step {i} vs world 1")


@pytest.mark.parametrize("case", sorted(CASES))
def test_leaves_are_placed_as_the_jax_shardings(runs, case):
    from repro_torch.models import params as tparams

    _, meta = runs.jax()
    shape, axes = CASES[case]["shape"], CASES[case]["axes"]
    mesh = tparams.AbstractMesh(tuple(shape), tuple(axes))
    model = build_model(dataclasses.replace(get_config("olmo-1b").smoke(), vocab=W.VOCAB))
    rules = getattr(tparams, CASES[case]["rules"])
    specs = W.paths(model.specs(rules, mesh))
    full = W.paths(runs.params)
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_global_batch_rows_and_full_tensor(runs, case):
    _, meta = runs.jax()
    _, data = W.model_and_data()
    for r in runs.get(case):
        coord = ",".join(map(str, r["coord"].tolist()))
        (lo, hi), _ = meta[case]["batch_index"][coord]
        for i in range(W.STEPS):
            want = data.batch_at(i)["tokens"]
            assert np.array_equal(r[f"batch{i}/local"], want[lo:hi])
            assert np.array_equal(r[f"batch{i}/local_by_spec"], want[lo:hi])
            plain = make_global_batch(data, i, device="cpu")["tokens"]
            assert r[f"batch{i}/full"].dtype == np.int64
            assert np.array_equal(r[f"batch{i}/full"], plain.numpy())


def test_int8_step_matches_jax(runs, world1_states):
    jarrays, meta = runs.jax()
    rank0 = runs.get("2x2")[0]
    (got_metrics,) = json.loads(str(rank0["int8_metrics"]))
    want_metrics = meta["2x2_int8"]["metrics"][0]
    got = _rank_state(rank0, "int8_0")
    lr = want_metrics["lr"]
    _metrics_close(got_metrics, want_metrics, "int8 vs jax")
    want = _jax_state(jarrays, "2x2_int8", 0)
    resolved = {k: np.abs(want[f"opt/m/{k[len('params/'):]}.q"]) >= 1
                for k in want if k.startswith("params/")}
    _states_agree(got, want, resolved, lr, "int8 vs jax")
    w1_state, w1_metrics = world1_states["int8", 0]
    _metrics_close(got_metrics, w1_metrics, "int8 vs world 1")
    _states_agree(got, w1_state, resolved, lr, "int8 vs world 1")


def test_int8_scale_is_the_global_row_absmax(runs):
    rank0 = runs.get("2x2")[0]
    assert bool(rank0["quant/q_equal"]) and bool(rank0["quant/scale_equal"])
    # the scale of a [rows over "data", columns over "model"] moment
    assert str(rank0["quant/scale_placements"]) == "(Shard(dim=0), Replicate())"


def test_blockwise_attention_over_sharded_heads(runs):
    rank0 = runs.get("2x2")[0]
    assert float(rank0["attn/y_err"]) <= 1e-5 * float(rank0["attn/y_max"])
    assert float(rank0["attn/grad_err"]) <= 1e-5 * float(rank0["attn/grad_max"])
    assert str(rank0["attn/placements"]) == "(Shard(dim=0), Shard(dim=2))"


def test_checkpoint_saved_on_2x2_restores_on_other_meshes(runs):
    rank0 = runs.get("2x2")[0]
    for tag in ("4x1", "1x4"):
        assert int(rank0[f"restore/{tag}/step"]) == W.STEPS
        assert bool(rank0[f"restore/{tag}/equal"]) and bool(rank0[f"restore/{tag}/on_mesh"])
    saved = _rank_state(rank0, f"f32_{W.STEPS - 1}")
    one = runs.world1()
    assert int(one["step"]) == W.STEPS and bool(one["on_mesh"])
    model, _ = W.model_and_data()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    template = {"params": params, "opt": tadamw.init_opt_state(params, AdamWConfig(**W.ADAMW))}
    plain, step = Checkpointer(runs.root / "2x2" / "ck22").restore(template)
    assert step == W.STEPS
    plain = {k: v.numpy() for k, v in W.paths(plain).items()}
    assert plain.keys() == saved.keys()
    for key, want in saved.items():
        for got in (one[f"state/{key}"], plain[key]):
            assert got.dtype == want.dtype and np.array_equal(got, want), key


def test_jax_checkpoint_restores_onto_2x2(runs):
    rank0 = runs.get("2x2")[0]
    opt = jadamw.AdamWConfig(**W.ADAMW)
    want = W.paths({"params": runs.params, "opt": jax.tree.map(
        np.asarray, jadamw.init_opt_state(runs.params, opt))})
    for key, w in want.items():
        got = rank0[f"jax_ckpt/{key}"]
        assert got.dtype == w.dtype and np.array_equal(got, w), key
    assert str(rank0["jax_ckpt_placements/params/embed/tok"]) == "(Shard(dim=1), Shard(dim=0))"


def test_c10d_all_gather_route_gives_the_same_bits(runs):
    rank0 = runs.get("2x2")[0]
    assert str(rank0["route/name"]) == "c10d all_gather_into_tensor"
    assert int(rank0["route/calls"]) > 0  # the steps' all-gathers took the route
    assert bool(rank0["route/metrics_equal"]) and bool(rank0["route/state_equal"])
    # the route is the routed mesh's: another mesh in the process keeps the
    # functional all-gather
    assert str(rank0["route/other_name"]) == "functional all_gather_into_tensor"
    assert bool(rank0["route/other_equal"]) and int(rank0["route/other_calls"]) == 0


def test_masked_sum_ce_equals_gather_ce():
    """The port's counterpart of ``tests/test_loss_sharding.py``: the
    masked-sum cross-entropy is bit for bit the gather's on one device, and
    the JAX package's loss within 1e-5."""
    jmodel = j_build_model(J_ARCHS["olmo-1b"].smoke())
    jp = jmodel.init(jax.random.key(0))
    tokens = np.array(jax.random.randint(jax.random.key(1), (2, 24), 0, jmodel.cfg.vocab))
    jloss = float(jsteps.loss_fn(jmodel, jp, {"tokens": tokens})[0])
    model = build_model(get_config("olmo-1b").smoke())
    params = params_from_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    batch = {"tokens": torch.from_numpy(tokens).long()}
    loss, parts = tsteps.loss_fn(model, params, batch)
    logits, _, _ = model.forward(params, batch)
    logits = tlayers.wide(logits[:, :-1])
    gathered = torch.gather(logits, -1, batch["tokens"][:, 1:, None])[..., 0]
    want = torch.mean(torch.logsumexp(logits, -1) - gathered)
    assert torch.equal(parts["ce"], want)
    assert abs(float(loss) - jloss) < 1e-5
    logp = torch.log_softmax(logits, -1)
    expect = -float(torch.gather(logp, -1, batch["tokens"][:, 1:, None]).mean())
    assert abs(float(loss) - expect) < 1e-5
