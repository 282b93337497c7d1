"""GAT on the port, on the CPU: the tile slot maps, the rewritten SpMM, the
plain SDDMM, the loss and every gradient against the benchmark's plain
reference (``h100bench/reference/gat.py``), the trainer's ``model="gat"``,
and the attention aggregation's spans and counter.

Tolerances: the port computes in float32 (the per-head products on the
``"stable"`` lane chain, the SDDMM's dot products, the softmax's segment
sums), the reference in float64, on a 512-node R-MAT graph with hub rows
of ~100 entries.  The loss agrees to 1e-6 relative and each leaf's
gradient to 1e-5 of its largest element: float32's 2**-24 times the
depth of the sums a gradient goes through (three layers, softmaxes and
products over hub rows of ~100 entries), with room.  Bitwise checks are where
the same values are written or summed in the same order.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.graph as tg
from h100bench import data, harness
from repro_torch import obs
from repro_torch.core import PartitionConfig, build_tiles
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.tile import tiles_from_arrays, tuned_partition_config
from repro_torch.graph.train import NodeClassifierTrainer
from repro_torch.kernels import autodiff, ops, ref
from repro_torch.kernels.hbp_spmv import hbp_sddmm
from repro_torch.obs.trace import PREFIX
from repro_torch.serving.registry import MatrixRegistry

GEOMETRIES = {
    "narrow": PartitionConfig(row_block=64, col_block=128, group=8, lane=8),
    "wide": PartitionConfig(row_block=128, col_block=256, group=8, lane=32),
    "lane128": PartitionConfig(row_block=256, col_block=512, group=8, lane=128),
    "tuned": None,
}
DIMS = [16, 24, 24, 5]
HEADS = 3


def _graph(log2_nodes=9, symmetric=True, edge_factor=8.0):
    g = data.rmat_graph({"log2_nodes": log2_nodes, "edge_factor": edge_factor,
                         "symmetric": symmetric, "seed": 4, "a": 0.57, "b": 0.19, "c": 0.19},
                        torch.device("cpu"))
    return g, data.program_csr(g)


def _valued(csr: CSRMatrix, seed=0) -> CSRMatrix:
    values = np.random.default_rng(seed).standard_normal(csr.nnz).astype(np.float32)
    return CSRMatrix(csr.indptr, csr.indices, values, csr.shape)


def _paired(csr, geometry):
    cfg = GEOMETRIES[geometry]
    csr_T = csr.transpose()
    return (build_tiles(csr, cfg or tuned_partition_config(csr)),
            build_tiles(csr_T, cfg or tuned_partition_config(csr_T)))


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "directed"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_slot_maps_rewrite_the_original_values_bit_for_bit(geometry, symmetric):
    _, csr = _graph(symmetric=symmetric)
    csr = _valued(tg.add_self_loops(csr))
    tiles, tiles_T = _paired(csr, geometry)
    maps = autodiff.attention_maps(csr, tiles, tiles_T, "cpu")
    values = torch.from_numpy(csr.data)
    for t, slot in ((tiles, maps.slot), (tiles_T, maps.slot_T)):
        rewritten = torch.zeros(t.data.size, dtype=torch.float32)
        rewritten[slot] = values
        assert torch.equal(rewritten.view(torch.int32),
                           torch.from_numpy(t.data).reshape(-1).view(torch.int32))
    assert torch.unique(maps.slot).numel() == csr.nnz == torch.unique(maps.slot_T).numel()


def test_tiles_from_arrays_carry_no_slot_map_and_refuse_a_rewrite():
    _, csr = _graph()
    tiles = build_tiles(csr, GEOMETRIES["narrow"])
    fields = {f: getattr(tiles, f) for f in ("data", "cols", "rowgroup", "colblock", "first",
                                             "perm", "shape", "cfg", "n_rowgroups")}
    bare = tiles_from_arrays(fields)
    assert bare.slot is None
    with pytest.raises(ValueError, match="slot map"):
        autodiff.attention_maps(csr, bare, bare, "cpu")


@pytest.mark.parametrize("strategy", ["stable", "reference", "fused"])
@pytest.mark.parametrize("geometry", ["narrow", "tuned"])
def test_rewritten_spmm_matches_torch_sparse_with_the_same_values(geometry, strategy):
    _, csr = _graph(symmetric=False)
    tiles, tiles_T = _paired(csr, geometry)
    maps = autodiff.attention_maps(csr, tiles, tiles_T, "cpu")
    g = torch.Generator().manual_seed(1)
    values = torch.rand((csr.nnz, HEADS), generator=g)
    x = torch.randn((csr.shape[1], 7), generator=g)
    rows = torch.from_numpy(np.repeat(np.arange(csr.n_rows), csr.row_nnz()))
    cols = torch.from_numpy(csr.indices)
    for dt, slot, (r, c) in ((ops.device_tiles(tiles, "cpu"), maps.slot, (rows, cols)),
                             (ops.device_tiles(tiles_T, "cpu"), maps.slot_T, (cols, rows))):
        staged = dt.data.clone()
        for h, t in enumerate(autodiff.rewritten_tiles(dt, slot, values)):
            want = torch.sparse_coo_tensor(torch.stack([r, c]), values[:, h].double(),
                                           dt.shape).to_dense() @ x.double()
            got = ops.hbp_spmm(t, x, strategy=strategy)
            torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(dt.data, staged)  # the staged values are left as they were


@pytest.mark.parametrize("block", [None, 100], ids=["one-block", "blocks"])
@pytest.mark.parametrize("heads,width", [(3, 250), (3, 40), (1, 7)])
def test_plain_sddmm_matches_the_dense_formula(heads, width, block, monkeypatch):
    if block is not None:
        monkeypatch.setattr(ref, "_SDDMM_BLOCK", block * heads * width)
    _, csr = _graph(log2_nodes=7)
    g = torch.Generator().manual_seed(2)
    n = csr.n_rows
    dy = torch.randn((n, heads * width), generator=g)
    z = torch.randn((n, heads * width), generator=g)
    indptr = torch.from_numpy(csr.indptr)
    cols = torch.from_numpy(csr.indices).to(torch.int32)
    got = hbp_sddmm(indptr, cols, dy, z, heads)
    dense = torch.einsum("ihc,jhc->ijh", dy.double().view(n, heads, width),
                         z.double().view(n, heads, width))
    rows = np.repeat(np.arange(n), csr.row_nnz())
    want = dense[rows, csr.indices]
    assert got.shape == (csr.nnz, heads)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5 * width ** 0.5)


def test_sddmm_refuses_what_its_kernel_does_not_take():
    indptr = torch.tensor([0, 1, 2])
    cols = torch.tensor([1, 0], dtype=torch.int32)
    dy = torch.zeros(2, 6)
    with pytest.raises(ValueError, match="heads"):
        hbp_sddmm(indptr, cols, dy, dy, 4)
    with pytest.raises(TypeError, match="int32"):
        hbp_sddmm(indptr, cols.long(), dy, dy, 3)
    with pytest.raises(ValueError, match="rows"):
        hbp_sddmm(torch.tensor([0, 2]), cols, dy, dy, 3)


def _gat_case(seed=3):
    g, csr = _graph()
    gen = torch.Generator().manual_seed(seed)
    params = []
    for i, (d_in, d_out) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        width = d_out if i == len(DIMS) - 2 else d_out // HEADS
        params.append((torch.randn(d_in, HEADS * width, generator=gen) / d_in ** 0.5,
                       torch.randn(d_in, HEADS * width, generator=gen) / d_in ** 0.5,
                       torch.randn(HEADS, width, generator=gen) * 0.3,
                       torch.randn(HEADS, width, generator=gen) * 0.3,
                       torch.randn(d_out, generator=gen) * 0.1))
    x = torch.randn(g.n, DIMS[0], generator=gen)
    labels = torch.randint(0, DIMS[-1], (g.n,), generator=gen)
    return g, csr, params, x, labels


def _port_loss_and_grads(agg, params, x, labels):
    leaves = [t.clone().requires_grad_(True) for p in params for t in p]
    layers = [tg.GATParams(*leaves[5 * i:5 * i + 5]) for i in range(len(params))]
    loss = torch.nn.functional.cross_entropy(tg.gat_forward(agg, layers, x), labels)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def test_gat_loss_and_every_gradient_match_the_plain_reference():
    g, csr, params, x, labels = _gat_case()
    trainer = NodeClassifierTrainer(DIMS, model="gat", heads=HEADS, device="cpu")
    agg = trainer.aggregator(trainer.prepare_adjacency(csr))
    loss, grads = _port_loss_and_grads(agg, params, x, labels)
    gnn = harness.load_module(harness.HERE / "reference" / "gnn.py")
    model = harness.arch_module("reference", {"arch": "gat"}).Model(
        g.indptr, g.indices, g.values, g.n, "float64")
    leaves = [t.double().requires_grad_(True) for p in params for t in p]
    layers = [leaves[5 * i:5 * i + 5] for i in range(len(params))]
    want = gnn.cross_entropy(model.forward(layers, x.double()), labels)
    want_grads = torch.autograd.grad(want, leaves)
    want = float(want.detach())
    assert abs(loss - want) <= 1e-6 * abs(want)
    for got, w in zip(grads, want_grads):
        assert float((got.double() - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_gat_trains_through_the_registry_pair_as_through_its_own_tiles(tmp_path):
    g, csr, params, x, labels = _gat_case()
    arrays = [[t.numpy() for t in p] for p in params]
    histories = []
    for registry in (MatrixRegistry(device="cpu", cache_dir=tmp_path, search=False), None):
        trainer = NodeClassifierTrainer(DIMS, model="gat", heads=HEADS, registry=registry,
                                        device="cpu")
        agg = trainer.aggregator(trainer.prepare_adjacency(csr))
        state = trainer.load_state(arrays)
        losses = []
        for _ in range(4):
            state, out = trainer.step(state, agg, x, labels)
            losses.append(out["loss"])
        histories.append(losses)
    assert histories[0] == histories[1]
    assert histories[0][-1] < histories[0][0]
    registry = MatrixRegistry(device="cpu", cache_dir=tmp_path, search=False)
    adj = tg.add_self_loops(csr)
    plan = registry.admit_pair(adj)
    with pytest.raises(ValueError, match="rewritable"):
        plan.attention_aggregator()
    assert registry.admit_pair(adj, rewritable=True) is plan and plan._attention is not None
    # the staged maps outlive the host slot arrays, which admission dropped
    assert plan.tiles.slot is None and registry.admit_pair(adj, rewritable=True) is plan
    plan.attention_aggregator()


def test_gat_module_and_trainer_init_carry_the_heads():
    _, _, params, x, _ = _gat_case()
    module = tg.GAT.from_params([[t.numpy() for t in p] for p in params])
    assert [tuple(p.a_src.shape) for p in module.params()] == [(3, 8), (3, 8), (3, 5)]
    state = NodeClassifierTrainer(DIMS, model="gat", heads=HEADS, device="cpu").init(0)
    assert [tuple(p.W.shape) for p in state.params] == [(16, 24), (24, 24), (24, 15)]
    assert [tuple(p.b.shape) for p in state.params] == [(24,), (24,), (5,)]
    with pytest.raises(ValueError, match="multiple"):
        tg.init_gat(torch.Generator().manual_seed(0), [16, 25, 5], 3)
    with pytest.raises(ValueError, match="op='sum'"):
        NodeClassifierTrainer(DIMS, model="gat", op="max", device="cpu")


@pytest.fixture()
def clean_obs():
    obs.disable()
    obs.reset()
    yield obs
    obs.disable()
    obs.reset()


def test_gat_step_yields_its_spans_and_counts_the_rewritten_slots(clean_obs):
    g, csr, params, x, labels = _gat_case()
    trainer = NodeClassifierTrainer(DIMS, model="gat", heads=HEADS, device="cpu")
    adj = trainer.prepare_adjacency(csr)
    agg = trainer.aggregator(adj)
    state = trainer.load_state([[t.numpy() for t in p] for p in params])
    state, _ = trainer.step(state, agg, x, labels)  # first step outside the profile
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(state, agg, x, labels)
    names = [e.name()[len(PREFIX):] for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIX)
             and e.device_type() == torch.autograd.DeviceType.CPU]
    count = {name: names.count(name) for name in set(names) if name.startswith("agg.")}
    layers = len(DIMS) - 1
    assert count == {"agg.attention": layers, "agg.forward": layers,
                     "agg.attention_backward": 2 * layers, "agg.backward": layers,
                     "agg.sddmm": layers}
    slots = obs.registry().value("agg.rewritten_slots", 0)
    assert slots == 2 * layers * adj.nnz * HEADS
