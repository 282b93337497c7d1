"""One rank of a mesh case of ``tests/test_torch_mesh.py`` and
``tests/test_torch_mesh_families.py``: gloo on the CPU.

    python tests/torch_mesh_worker.py CASE_JSON RANK WORLD INIT_URL OUT_DIR

``CASE_JSON`` names the mesh (``shape``, ``axes``), the rule set
(``rules``), the model (``arch``, default OLMo-1B, and ``overrides`` of
its smoke config), its parameters carried from the JAX package
(``params``, an ``.npz`` keyed by ``/``-joined tree paths), the number of
steps (``steps``, default 2) and the case's extras.  The rank places the
parameters (``place``), draws the global batches on the mesh
(``make_global_batch(mesh=)`` and ``sharding=``), takes the train steps
with 2 microbatches and remat under ``sharding_ctx`` with
``param_shardings``, and writes what the test compares to
``OUT_DIR/rank<RANK>.npz``: its coordinate, its local shard of each
parameter and of each batch, and (rank 0) the metrics and the full tensors
of the state after each step.  A ``world1`` case restores a ``(2, 2)``
case's checkpoint onto the 1x1 mesh of one rank.  A ``family`` case adds
one global batch's loss, aux and MoE routes, a rematerialised backward
taken outside the sharding context, and the checkpoint restored onto
``(1, 4)``.  A ``surfaces`` case (2 ranks, for
``tests/test_torch_sharding.py``) drives each sharding surface on the
meshes ``(2, 1)`` and ``(1, 2)``.  No failure is caught: a rank that
raises exits non-zero.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.models import attention as tattention
from repro_torch.models import params as tparams
from repro_torch.optim import AdamWConfig, opt_state_specs
from repro_torch.optim import adamw as tadamw
from repro_torch.train import make_train_step

VOCAB = 200  # padded to 256: the padded-vocab mask runs
BATCH, SEQ, MICRO, STEPS = 8, 32, 2, 2
ADAMW = dict(lr_peak=1e-3, warmup_steps=2, decay_steps=50)


def case_model(case):
    """The model and data of a case: ``arch`` (default OLMo-1B) with
    ``overrides`` of its smoke config."""
    return model_and_data(case.get("arch", "olmo-1b"), **case.get("overrides", {}))


def model_and_data(arch="olmo-1b", **overrides):
    cfg = dataclasses.replace(get_config(arch).smoke(), vocab=VOCAB, **overrides)
    return build_model(cfg), SyntheticLM(DataConfig(vocab=VOCAB, seq_len=SEQ,
                                                    global_batch=BATCH, seed=0))


def nested(flat, template, prefix=""):
    """``flat`` (``{"a/b": x}``) in the structure of ``template`` (a dict
    tree; its empty dicts, which an ``.npz`` drops, kept)."""
    if isinstance(template, dict):
        return {k: nested(flat, v, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    return flat[prefix]


def paths(tree, prefix=""):
    """``{"a/b": leaf}`` of a tree of dicts and QTensors (``.q``/``.scale``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in paths(sub, f"{prefix}/{key}" if prefix else key).items()}
    if isinstance(tree, tadamw.QTensor):
        return {f"{prefix}.q": tree.q, f"{prefix}.scale": tree.scale}
    return {prefix: tree}


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def shardings(model, rules, mesh):
    return tparams.tree_map(lambda s: tparams.NamedSharding(mesh, s), model.specs(rules, mesh))


def state_shardings(model, rules, mesh, opt):
    specs = model.specs(rules, mesh)
    tree = {"params": specs, "opt": opt_state_specs(model.abstract(), specs, opt, mesh)}

    def named(t):
        if isinstance(t, dict):
            return {k: named(v) for k, v in t.items()}
        if isinstance(t, tadamw.QTensor):
            return tadamw.QTensor(*(tparams.NamedSharding(mesh, s) for s in t))
        return tparams.NamedSharding(mesh, t)

    return named(tree)


def run_steps(model, params, data, mesh, rules, opt, steps=STEPS):
    """``steps`` mesh steps from ``params``: (state after each step, metrics)."""
    step = make_train_step(model, opt, n_microbatch=MICRO, remat=True,
                           param_shardings=shardings(model, rules, mesh))
    state = {"params": params, "opt": tadamw.init_opt_state(params, opt)}
    states, metrics = [], []
    with tparams.sharding_ctx(mesh, rules):
        for i in range(steps):
            state, m = step(state, make_global_batch(data, i, mesh=mesh))
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def record(out, tag, state):
    """Every rank gathers the state's full tensors; they go in ``out``."""
    for key, leaf in paths(state).items():
        out[f"{tag}/{key}"] = full(leaf).numpy()


def mesh_case(case, rank, out_dir):
    mesh = make_mesh(tuple(case["shape"]), tuple(case["axes"]), "cpu")
    rules = getattr(tparams, case["rules"])
    model, data = case_model(case)
    steps = case.get("steps", STEPS)
    jparams = nested(dict(np.load(case["params"])), model.defs)
    params = tparams.tree_map(tparams.place, tparams.params_from_arrays(jparams, device="cpu"),
                              shardings(model, rules, mesh))
    out = {"coord": np.asarray(mesh.get_coordinate())}
    for key, leaf in paths(params).items():
        out[f"local/{key}"] = leaf.to_local().numpy()
        out[f"placements/{key}"] = np.asarray(str(leaf.placements))
    for i in range(steps):
        batch = make_global_batch(data, i, mesh=mesh)["tokens"]
        spec = tparams.logical_spec((BATCH, SEQ), ("batch", None), rules, mesh)
        by_spec = make_global_batch(
            data, i, sharding={"tokens": tparams.NamedSharding(mesh, spec)})["tokens"]
        out[f"batch{i}/local"] = batch.to_local().numpy()
        out[f"batch{i}/local_by_spec"] = by_spec.to_local().numpy()
        out[f"batch{i}/full"] = batch.full_tensor().numpy()
        out[f"batch{i}/placements"] = np.asarray(str(batch.placements))

    opt = AdamWConfig(**ADAMW)
    states, metrics = run_steps(model, params, data, mesh, rules, opt, steps)
    for i, st in enumerate(states):
        record(out, f"f32_{i}", st)
    out["f32_metrics"] = np.asarray(json.dumps(metrics))
    out["state_placements_ok"] = np.asarray(all(
        leaf.placements == tparams.placements(spec.spec, mesh)
        for leaf, spec in zip(tadamw.tree_leaves(states[-1]["params"]),
                              tadamw.tree_leaves(shardings(model, rules, mesh)))))

    if case.get("extra"):
        extras(case, rank, mesh, rules, model, data, params, states, metrics, out, out_dir)
    if case.get("family"):
        family_extras(case, mesh, rules, model, data, params, states, out, out_dir)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def extras(case, rank, mesh, rules, model, data, params, states, metrics, out, out_dir):
    """The ``(2, 2)`` case's extras: int8, the quantizer, the blockwise
    attention, the checkpoint across meshes, and last the c10d route."""
    # --- int8 moments, one step ---------------------------------------------
    opt8 = AdamWConfig(**ADAMW, state_dtype="int8")
    st8, m8 = run_steps(model, params, data, mesh, rules, opt8, steps=1)
    record(out, "int8_0", st8[0])
    out["int8_metrics"] = np.asarray(json.dumps(m8))

    # --- the int8 scale of a row sharded over "model" -----------------------
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 64)).astype(np.float32))
    xd = distribute_tensor(x, mesh, [Shard(0), Shard(1)])
    qd, qp = tadamw._quantize(xd), tadamw._quantize(x)
    out["quant/q_equal"] = np.asarray(torch.equal(qd.q.full_tensor(), qp.q))
    out["quant/scale_equal"] = np.asarray(torch.equal(qd.scale.full_tensor(), qp.scale))
    out["quant/scale_placements"] = np.asarray(str(qd.scale.placements))

    # --- blockwise attention, heads over "model", batch over "data" ---------
    tattention._DENSE_LIMIT = 0  # the blockwise path at any length
    g = np.random.default_rng(6)
    B, S, H, hd = 2, 2048, 4, 16  # 4 query chunks of 512, 2 key chunks of 1024
    qkv = [torch.from_numpy(g.standard_normal((B, S, H, hd)).astype(np.float32))
           for _ in range(3)]
    pos = torch.arange(S)
    w = torch.from_numpy(g.standard_normal((B, S, H, hd)).astype(np.float32))
    plain = [t.clone().requires_grad_() for t in qkv]
    y = tattention._attend(*plain, pos, pos, True)
    (y * w).sum().backward()
    place = [Shard(0), Shard(2)]
    dts = [distribute_tensor(t, mesh, place).requires_grad_() for t in qkv]
    with tparams.sharding_ctx(mesh, rules):
        yd = tattention._attend(*dts, pos, pos, True)
    (yd * distribute_tensor(w, mesh, place)).sum().backward()
    out["attn/y_err"] = np.asarray((yd.full_tensor() - y).abs().max().item())
    out["attn/y_max"] = np.asarray(y.abs().max().item())
    out["attn/grad_err"] = np.asarray(max((d.grad.full_tensor() - p.grad).abs().max().item()
                                          for d, p in zip(dts, plain)))
    out["attn/grad_max"] = np.asarray(max(p.grad.abs().max().item() for p in plain))
    out["attn/placements"] = np.asarray(str(yd.placements))
    tattention._DENSE_LIMIT = 1 << 22

    # --- checkpoint: saved on (2, 2), restored onto (4, 1) and (1, 4) -------
    opt = AdamWConfig(**ADAMW)
    ck = Checkpointer(Path(out_dir) / "ck22")
    ck.save(STEPS, states[-1], blocking=True)
    saved = {k: full(v) for k, v in paths(states[-1]).items()}
    for shape in ((4, 1), (1, 4)):
        other = make_mesh(shape, ("data", "model"), "cpu")
        got, step = ck.restore(states[-1], shardings=state_shardings(model, rules, other, opt))
        tag = "x".join(map(str, shape))
        out[f"restore/{tag}/step"] = np.asarray(step)
        out[f"restore/{tag}/equal"] = np.asarray(all(
            torch.equal(full(v), saved[k]) and v.dtype == saved[k].dtype
            for k, v in paths(got).items()))
        out[f"restore/{tag}/on_mesh"] = np.asarray(all(
            isinstance(v, DTensor) and v.device_mesh == other
            for k, v in paths(got["params"]).items()))
    got, _ = Checkpointer(case["jax_ckpt"]).restore(
        states[-1], shardings=state_shardings(model, rules, mesh, opt))
    for key, leaf in paths(got).items():
        out[f"jax_ckpt/{key}"] = full(leaf).numpy()
        if key.startswith("params/"):
            out[f"jax_ckpt_placements/{key}"] = np.asarray(str(leaf.placements))

    # --- the c10d all-gather route: the same steps, the same bits -----------
    # (counted at c10d's collective, which only the routed groups reach)
    calls = []
    c10d = dist.all_gather_into_tensor

    def counted(*args, **kwargs):
        calls.append(1)
        return c10d(*args, **kwargs)

    dist.all_gather_into_tensor = counted
    other = make_mesh((4,), ("data",), "cpu")  # the world's group, none of mesh's
    tparams.c10d_all_gathers(mesh)
    route = tparams.collective_route(mesh)
    states2, metrics2 = run_steps(model, params, data, mesh, rules, opt)
    out["route/name"] = np.asarray(route)
    out["route/calls"] = np.asarray(len(calls))
    out["route/metrics_equal"] = np.asarray(metrics2 == metrics)
    out["route/state_equal"] = np.asarray(all(
        torch.equal(full(a), full(b)) for s1, s2 in zip(states, states2)
        for a, b in zip(tadamw.tree_leaves(s1), tadamw.tree_leaves(s2))))
    # another mesh's groups keep the functional all-gather in this process
    before = len(calls)
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    xd = distribute_tensor(x, other, [Shard(0)])
    out["route/other_name"] = np.asarray(tparams.collective_route(other))
    out["route/other_equal"] = np.asarray(torch.equal(xd.full_tensor(), x))
    out["route/other_calls"] = np.asarray(len(calls) - before)
    dist.all_gather_into_tensor = c10d


def skewed_tokens(data):
    """The first global batch with its second half of rows one token
    repeated: the rows of the two halves route unlike each other, so a
    product of the halves' means is not the mean of their products."""
    tokens = torch.from_numpy(data.batch_at(0)["tokens"]).long()
    tokens[BATCH // 2:] = 7
    return tokens


def family_extras(case, mesh, rules, model, data, params, states, out, out_dir):
    """A family case's extras: the loss of one global batch
    (:func:`skewed_tokens`) with its aux and (MoE) the top-k routes of each
    layer, on this rank's rows; its rematerialised gradients with the
    backward taken inside and outside the sharding context; the
    checkpoint saved on this mesh, restored onto ``(1, 4)``."""
    from repro_torch.models import moe as tmoe
    from repro_torch.train.steps import loss_fn

    spec = tparams.logical_spec((BATCH, SEQ), ("batch", None), rules, mesh)
    tokens = tparams.place(skewed_tokens(data), tparams.NamedSharding(mesh, spec))
    with tparams.sharding_ctx(mesh, rules), tmoe.record_routes() as routes:
        loss, parts = loss_fn(model, params, {"tokens": tokens})
    out["one/loss"] = np.asarray(float(full(loss)))
    out["one/aux"] = np.asarray(float(full(parts["aux"])))
    out["one/routes"] = np.stack([r.numpy() for r in routes]) if routes else np.zeros(0)
    out["one/rows"] = np.asarray(tokens.to_local().shape[0])

    # the rematerialised forward runs in the backward, which on the card is
    # another thread, outside the caller's context: a backward taken after
    # the context has closed gives the same gradients bit for bit
    leaves, rebuild = tadamw.tree_flatten(params)
    grads = []
    for inside in (True, False):
        live = [p.detach().requires_grad_() for p in leaves]
        with tparams.sharding_ctx(mesh, rules):
            loss, _ = loss_fn(model, rebuild(live), {"tokens": tokens}, remat=True)
            got = torch.autograd.grad(loss, live) if inside else None
        grads.append(got or torch.autograd.grad(loss, live))
    out["remat/outside_equal"] = np.asarray(all(
        torch.equal(full(a), full(b)) for a, b in zip(*grads)))

    opt = AdamWConfig(**ADAMW)
    ck = Checkpointer(Path(out_dir) / "ck")
    ck.save(len(states), states[-1], blocking=True)
    saved = {k: full(v) for k, v in paths(states[-1]).items()}
    other = make_mesh((1, 4), ("data", "model"), "cpu")
    got, step = ck.restore(states[-1], shardings=state_shardings(model, rules, other, opt))
    out["restore/1x4/step"] = np.asarray(step)
    out["restore/1x4/equal"] = np.asarray(all(
        torch.equal(full(v), saved[k]) and v.dtype == saved[k].dtype
        for k, v in paths(got).items()))
    out["restore/1x4/on_spec"] = np.asarray(all(
        isinstance(v, DTensor) and v.device_mesh == other
        and v.placements == tparams.placements(s.spec, other)
        for v, s in zip(tadamw.tree_leaves(got["params"]),
                        tadamw.tree_leaves(shardings(model, rules, other)))))


def world1_case(case, out_dir):
    """A ``(2, 2)`` case's checkpoint restored onto the 1x1 mesh."""
    mesh = make_host_mesh("cpu")
    model, _ = case_model(case)
    rules = getattr(tparams, case["rules"])
    opt = AdamWConfig(**ADAMW)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    template = {"params": params, "opt": tadamw.init_opt_state(params, opt)}
    got, step = Checkpointer(case["ckpt"]).restore(
        template, shardings=state_shardings(model, rules, mesh, opt))
    out = {"step": np.asarray(step), "on_mesh": np.asarray(all(
        isinstance(v, DTensor) for v in paths(got).values() if v.dim() > 0))}
    for key, leaf in paths(got).items():
        out[f"state/{key}"] = full(leaf).numpy()
    np.savez(Path(out_dir) / "rank0.npz", **out)


def surfaces_case(case, rank, out_dir):
    """``shard``, ``constrain_defs``, ``make_train_step(param_shardings=)``,
    ``make_global_batch(mesh=, sharding=)`` and ``Checkpointer.restore(
    shardings=)`` on 2 ranks: the batch over ``data`` on ``(2, 1)``, the
    weights over ``model`` on ``(1, 2)``."""
    by_data = make_mesh((2, 1), ("data", "model"), "cpu")
    by_model = make_mesh((1, 2), ("data", "model"), "cpu")
    rules = tparams.TRAIN_RULES
    out = {"coord": np.asarray(by_data.get_coordinate())}

    # --- shard and constrain_defs --------------------------------------------
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    xd = distribute_tensor(x, by_model, [Replicate()] * 2)
    defs = {"w": tparams.ParamDef((4, 8), ("embed", "mlp"))}
    assert tparams.shard(xd, "batch", "mlp") is xd  # identity outside a context
    with tparams.sharding_ctx(by_model, rules):
        y = tparams.shard(xd, "batch", "mlp")
        w = tparams.constrain_defs({"w": xd}, defs)["w"]
        try:
            tparams.shard(x, "batch", "mlp")
            out["plain_raises"] = np.asarray(False)
        except TypeError:
            out["plain_raises"] = np.asarray(True)
    out["shard/placements"] = np.asarray(str(y.placements))
    out["shard/equal"] = np.asarray(torch.equal(y.full_tensor(), x))
    out["constrain/placements"] = np.asarray(str(w.placements))
    out["constrain/equal"] = np.asarray(torch.equal(w.full_tensor(), x))

    # --- the global batch on (2, 1) ------------------------------------------
    data = SyntheticLM(DataConfig(vocab=128, seq_len=8, global_batch=4, seed=2))
    spec = tparams.logical_spec((4, 8), ("batch", None), rules, by_data)
    for tag, got in (("mesh", make_global_batch(data, 3, mesh=by_data)),
                     ("sharding", make_global_batch(data, 3, sharding={
                         "tokens": tparams.NamedSharding(by_data, spec)}))):
        out[f"batch/{tag}/local"] = got["tokens"].to_local().numpy()
        out[f"batch/{tag}/full"] = got["tokens"].full_tensor().numpy()

    # --- the train step: batch over data, then weights over model ------------
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=2, vocab=128)
    model = build_model(cfg)
    opt = AdamWConfig(lr_peak=1e-2, warmup_steps=1)
    train = SyntheticLM(DataConfig(vocab=128, seq_len=8, global_batch=4, seed=1))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for tag, mesh in (("data", by_data), ("model", by_model)):
        placed = tparams.tree_map(tparams.place, params, shardings(model, rules, mesh))
        states, metrics = run_steps(model, placed, train, mesh, rules, opt)
        record(out, f"step/{tag}", states[-1])
        out[f"step/{tag}/metrics"] = np.asarray(json.dumps(metrics))

    # --- a checkpoint restored onto either mesh ------------------------------
    state = {"params": params, "opt": tadamw.init_opt_state(params, AdamWConfig(
        state_dtype="int8"))}
    ck = Checkpointer(Path(out_dir) / "ck")
    if rank == 0:
        ck.save(5, state, blocking=True)
    dist.barrier()
    for tag, mesh in (("data", by_data), ("model", by_model)):
        got, step = ck.restore(state, shardings=state_shardings(
            model, rules, mesh, AdamWConfig(state_dtype="int8")))
        out[f"restore/{tag}/step"] = np.asarray(step)
        out[f"restore/{tag}/equal"] = np.asarray(all(
            isinstance(v, DTensor) and torch.equal(v.full_tensor(), paths(state)[k])
            and v.dtype == paths(state)[k].dtype for k, v in paths(got).items()))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def main() -> None:
    case = json.loads(sys.argv[1])
    rank, world, init, out_dir = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)  # the ranks share the host's cores
    if case["kind"] == "world1":
        world1_case(case, out_dir)
        dist.destroy_process_group()
        return
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        (surfaces_case if case["kind"] == "surfaces" else mesh_case)(case, rank, out_dir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
