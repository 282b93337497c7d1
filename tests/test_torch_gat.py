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
import importlib

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
from repro_torch.kernels.hbp_spmv import (
    RowWalk,
    hbp_edge_softmax,
    hbp_edge_softmax_backward,
    hbp_edge_softmax_columns,
    hbp_rewrite,
    hbp_sddmm,
    row_walk,
)
from repro_torch.obs.trace import PREFIX
from repro_torch.serving.registry import MatrixRegistry

# the kernel module (the package's ``hbp_spmv`` is the ops entry point)
_KERNELS = importlib.import_module("repro_torch.kernels.hbp_spmv")

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
    values = torch.from_numpy(csr.data)[:, None]
    for t, entry in ((tiles, maps.entry), (tiles_T, maps.entry_T)):
        assert entry.shape == (t.data.size,) and entry.dtype == torch.int32
        rewritten = hbp_rewrite(entry, values)
        assert torch.equal(rewritten.view(torch.int32),
                           torch.from_numpy(t.data).reshape(1, -1).view(torch.int32))
        stored = entry[entry >= 0]
        assert torch.equal(torch.sort(stored).values, torch.arange(csr.nnz, dtype=torch.int32))


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
    for dt, entry, (r, c) in ((ops.device_tiles(tiles, "cpu"), maps.entry, (rows, cols)),
                              (ops.device_tiles(tiles_T, "cpu"), maps.entry_T, (cols, rows))):
        staged = dt.data.clone()
        for h, t in enumerate(autodiff.rewritten_tiles(dt, entry, values)):
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


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "directed"])
def test_attention_maps_carry_the_transpose_and_the_row_walks(symmetric, monkeypatch):
    monkeypatch.setattr(_KERNELS, "SOFTMAX_LONG_ROW", 100)  # this graph's hubs: ~300 entries
    _, csr = _graph(symmetric=symmetric, edge_factor=48.0)
    csr = _valued(tg.add_self_loops(csr))
    maps = autodiff.attention_maps(csr, *_paired(csr, "narrow"), "cpu")
    csr_T = csr.transpose()
    assert torch.equal(maps.indptr_T, torch.from_numpy(csr_T.indptr))
    assert maps.perm_T.dtype == torch.int32
    rows = torch.from_numpy(np.repeat(np.arange(csr.n_rows), csr.row_nnz()))
    perm = maps.perm_T.long()
    assert torch.equal(rows[perm], torch.from_numpy(csr_T.indices).long())
    assert torch.equal(torch.from_numpy(csr.data)[perm], torch.from_numpy(csr_T.data))
    assert torch.equal(torch.sort(perm).values, torch.arange(csr.nnz))
    for walk, indptr in ((maps.walk, csr.indptr), (maps.walk_T, csr_T.indptr)):
        lengths = torch.from_numpy(np.diff(indptr))
        order = walk.order.long()
        assert walk.order.dtype == torch.int32
        assert torch.equal(torch.sort(order).values, torch.arange(lengths.numel()))
        assert bool(torch.all(lengths[order][:-1] >= lengths[order][1:]))  # longest first
        assert walk.n_long == int((lengths > 100).sum()) > 0


class _PlainSoftmax(torch.autograd.Function):
    """The plain edge softmax as a Function whose backward is the plain
    backward by rows and the column sums (what ``_Attention`` runs)."""

    @staticmethod
    def forward(ctx, s_src, s_dst, maps):
        alpha = ref.edge_softmax(maps.indptr, maps.cols, s_src, s_dst)
        ctx.save_for_backward(s_src, s_dst, alpha)
        ctx.maps = maps
        return alpha

    @staticmethod
    def backward(ctx, d_alpha):
        s_src, s_dst, alpha = ctx.saved_tensors
        m = ctx.maps
        de, d_dst = ref.edge_softmax_backward(m.indptr, m.cols, s_src, s_dst, alpha, d_alpha)
        return ref.edge_softmax_columns(m.indptr_T, m.perm_T, de), d_dst, None


def _dense_softmax(csr, s_src, s_dst):
    """``α`` at the stored entries, from a dense masked softmax."""
    n, m = csr.shape
    rows = np.repeat(np.arange(n), csr.row_nnz())
    stored = torch.zeros(n, m, dtype=torch.bool)
    stored[rows, csr.indices] = True
    e = torch.nn.functional.leaky_relu(s_dst[:, None, :] + s_src[None, :, :],
                                       ref.NEGATIVE_SLOPE)
    alpha = torch.softmax(e.masked_fill(~stored[:, :, None], float("-inf")), dim=1)
    return alpha[rows, csr.indices]


@pytest.mark.parametrize("heads", [1, 3])
def test_plain_edge_softmax_and_its_backward_match_autograd_of_the_dense_formula(heads):
    _, csr = _graph(log2_nodes=6, symmetric=False)
    csr = tg.add_self_loops(csr)
    maps = autodiff.attention_maps(csr, *_paired(csr, "narrow"), "cpu")
    g = torch.Generator().manual_seed(5)
    s_src, s_dst = (2 * torch.randn(csr.n_rows, heads, generator=g, dtype=torch.float64)
                    for _ in range(2))
    d_alpha = torch.randn(csr.nnz, heads, generator=g, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (s_src, s_dst)]
    want = _dense_softmax(csr, *leaves)
    want_grads = torch.autograd.grad(want, leaves, d_alpha)
    got_leaves = [t.clone().requires_grad_(True) for t in (s_src, s_dst)]
    got = _PlainSoftmax.apply(*got_leaves, maps)
    torch.testing.assert_close(got, want.detach(), rtol=1e-12, atol=1e-14)
    for a, b in zip(torch.autograd.grad(got, got_leaves, d_alpha), want_grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    assert torch.autograd.gradcheck(lambda a, b: _PlainSoftmax.apply(a, b, maps),
                                    [t.clone().requires_grad_(True) for t in (s_src, s_dst)])


def _softmax_operands(heads=3):
    indptr = torch.tensor([0, 2, 2, 3])
    cols = torch.tensor([0, 2, 1], dtype=torch.int32)
    walk = row_walk(indptr)
    return indptr, cols, walk, torch.zeros(3, heads)


def test_edge_softmax_wrappers_refuse_what_their_kernels_do_not_take():
    indptr, cols, walk, s = _softmax_operands()
    alpha = torch.zeros(3, 3)
    assert hbp_edge_softmax(indptr, cols, walk, s, s).shape == (3, 3)
    with pytest.raises(TypeError, match="int32"):
        hbp_edge_softmax(indptr, cols.long(), walk, s, s)
    with pytest.raises(TypeError, match="int64"):
        hbp_edge_softmax(indptr.int(), cols, walk, s, s)
    with pytest.raises(TypeError, match="float32"):
        hbp_edge_softmax(indptr, cols, walk, s.double(), s.double())
    with pytest.raises(ValueError, match="heads"):
        hbp_edge_softmax(indptr, cols, walk, torch.zeros(3, 0), torch.zeros(3, 0))
    # the card's kernels take at most 8 heads; the plain versions any number
    assert hbp_edge_softmax(indptr, cols, walk, torch.zeros(3, 9), torch.zeros(3, 9)).shape == (
        3, 9)
    with pytest.raises(ValueError, match="shape"):
        hbp_edge_softmax(indptr, cols, walk, s, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="walk"):
        hbp_edge_softmax(indptr, cols, RowWalk(walk.order[:2], 0), s, s)
    with pytest.raises(ValueError, match="walk"):
        hbp_edge_softmax(indptr, cols, RowWalk(walk.order, 4), s, s)
    with pytest.raises(ValueError, match="contiguous"):
        hbp_edge_softmax(indptr, cols, walk, torch.zeros(3, 6)[:, ::2], s)
    with pytest.raises(ValueError, match="one device"):
        hbp_edge_softmax(indptr, cols, walk, s.to("meta"), s)
    with pytest.raises(ValueError, match="one device"):
        hbp_edge_softmax(indptr.to("meta"), cols, walk, s, s)
    with pytest.raises(ValueError, match="shape"):
        hbp_edge_softmax_backward(indptr, cols, walk, s, s, alpha, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        hbp_edge_softmax_backward(indptr, cols, walk, s, s, alpha.t(), alpha)
    with pytest.raises(TypeError, match="float32"):
        hbp_edge_softmax_backward(indptr, cols, walk, s, s, alpha, alpha.half())
    with pytest.raises(ValueError, match="one device"):
        hbp_edge_softmax_backward(indptr, cols, walk, s, s, alpha, alpha.to("meta"))
    with pytest.raises(ValueError, match="heads"):
        hbp_edge_softmax_columns(indptr, cols, walk, torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        hbp_edge_softmax_columns(indptr, cols, walk, torch.zeros(4, 3))
    with pytest.raises(TypeError, match="int32"):
        hbp_edge_softmax_columns(indptr, cols.long(), walk, alpha)
    entry = torch.tensor([2, -1, 0, 1], dtype=torch.int32)
    assert hbp_rewrite(entry, alpha).shape == (3, 4)
    with pytest.raises(ValueError, match="entry"):
        hbp_rewrite(entry.long(), alpha)
    with pytest.raises(ValueError, match="entry"):
        hbp_rewrite(entry[None], alpha)
    with pytest.raises(ValueError, match="entry"):
        hbp_rewrite(entry.to("meta"), alpha)
    with pytest.raises(TypeError, match="float32"):
        hbp_rewrite(entry, alpha.double())
    with pytest.raises(ValueError, match="contiguous"):
        hbp_rewrite(entry, torch.zeros(3, 6)[:, ::2])
    with pytest.raises(ValueError, match="heads"):
        hbp_rewrite(entry, torch.zeros(3, 0))


def test_edge_softmax_wrappers_take_their_plain_versions_on_the_cpu():
    _, csr = _graph(log2_nodes=7)
    csr = tg.add_self_loops(csr)
    maps = autodiff.attention_maps(csr, *_paired(csr, "tuned"), "cpu")
    g = torch.Generator().manual_seed(6)
    s_src, s_dst = torch.randn(2, csr.n_rows, HEADS, generator=g).unbind(0)
    d_alpha = torch.randn(csr.nnz, HEADS, generator=g)
    wrappers = (hbp_edge_softmax, hbp_edge_softmax_backward, hbp_edge_softmax_columns,
                hbp_rewrite)
    before = [w.launches for w in wrappers]
    alpha = hbp_edge_softmax(maps.indptr, maps.cols, maps.walk, s_src, s_dst)
    assert torch.equal(alpha, ref.edge_softmax(maps.indptr, maps.cols, s_src, s_dst))
    de, d_dst = hbp_edge_softmax_backward(maps.indptr, maps.cols, maps.walk, s_src, s_dst,
                                          alpha, d_alpha)
    want = ref.edge_softmax_backward(maps.indptr, maps.cols, s_src, s_dst, alpha, d_alpha)
    assert torch.equal(de, want[0]) and torch.equal(d_dst, want[1])
    d_src = hbp_edge_softmax_columns(maps.indptr_T, maps.perm_T, maps.walk_T, de)
    # Aᵀ's walk adds each column's entries in A's order: index_add_'s bits
    cols = maps.cols.long()
    assert torch.equal(d_src, torch.zeros_like(s_src).index_add_(0, cols, de))
    assert torch.equal(hbp_rewrite(maps.entry_T, alpha),
                       ref.rewritten_values(maps.entry_T, alpha))
    assert [w.launches for w in wrappers] == before


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
                     "agg.attention_backward": layers, "agg.backward": layers,
                     "agg.sddmm": layers}
    slots = obs.registry().value("agg.rewritten_slots", 0)
    assert slots == 2 * layers * adj.nnz * HEADS
