"""The pieces the gat.train.kron16 and kron16.spmm-k128 cells add: GAT's
plain reference against autograd through dense masks, GAT's work counts by
hand, both cells and the three attention metrics found by name, and the
metrics' readers on a slice with and without the program's ranges."""
import pytest
import torch

from h100bench import harness, work
from h100bench.reference import gnn

BENCH = harness.manifest()
N, NNZ = 4, 6  # the work counts' tiny graph


def csr_of(stored: torch.Tensor) -> gnn.Csr:
    idx = stored.nonzero()
    indptr = torch.zeros(stored.shape[0] + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(stored.sum(1), 0)
    return gnn.Csr(indptr, idx[:, 1], torch.ones(idx.shape[0], dtype=torch.float64),
                   stored.shape[1])


def reference():
    return harness.arch_module("reference", {"arch": "gat"})


def _dense_gat_layer(stored, z, a_src, a_dst):
    """GAT's aggregation from dense masks, by autograd alone: ``[n, H, C]``."""
    s_src, s_dst = (z * a_src).sum(-1), (z * a_dst).sum(-1)
    e = torch.nn.functional.leaky_relu(s_dst[:, None, :] + s_src[None, :, :], 0.2)
    alpha = torch.softmax(e.masked_fill(~stored[:, :, None], float("-inf")), dim=1)
    return torch.einsum("ijh,jhc->ihc", alpha, z)


def test_attention_and_its_backward_match_autograd_through_dense():
    gat = reference()
    g = torch.Generator().manual_seed(3)
    n, heads, width = 9, 2, 3
    stored = torch.rand(n, n, generator=g) < 0.35
    stored[4] = False  # a node with no edge keeps its self-loop
    s = gat.structure(gat.self_looped(csr_of(stored)))
    looped = stored.clone()
    looped.fill_diagonal_(True)
    z = torch.randn(n, heads, width, generator=g, dtype=torch.float64, requires_grad=True)
    a = [torch.randn(heads, width, generator=g, dtype=torch.float64, requires_grad=True)
         for _ in range(2)]
    y = gat.Attention.apply(z, (z * a[0]).sum(-1), (z * a[1]).sum(-1), s)
    want = _dense_gat_layer(looped, z, *a)
    assert torch.allclose(y, want)
    y_bar = torch.randn(n, heads, width, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(y, [z, *a], y_bar)
    for got_g, want_g in zip(got, torch.autograd.grad(want, [z, *a], y_bar)):
        assert torch.allclose(got_g, want_g)
    scores = [torch.randn(n, heads, generator=g, dtype=torch.float64, requires_grad=True)
              for _ in range(2)]
    assert torch.autograd.gradcheck(
        lambda z_, s_src, s_dst: gat.Attention.apply(z_, s_src, s_dst, s),
        (z.detach().requires_grad_(True), *scores))


def test_sddmm_in_blocks_equals_one_block(monkeypatch):
    gat = reference()
    g = torch.Generator().manual_seed(4)
    stored = torch.rand(7, 7, generator=g) < 0.5
    s = gat.structure(gat.self_looped(csr_of(stored)))
    dy, z = torch.randn(2, 7, 2, 3, generator=g, dtype=torch.float64)
    whole = gat.sddmm(s, dy, z)
    monkeypatch.setattr(gat, "_EDGE_BLOCK", 2 * 3 * 2)  # two entries a block
    assert torch.equal(gat.sddmm(s, dy, z), whole)
    assert torch.allclose(whole, (dy[s.rows] * z[s.a.indices]).sum(-1))


def test_the_model_averages_the_output_heads():
    gat = reference()
    g = torch.Generator().manual_seed(5)
    stored = torch.rand(6, 6, generator=g) < 0.5
    model = gat.Model(*csr_of(stored)[:3], 6, "float64")
    x = torch.randn(6, 3, generator=g, dtype=torch.float64)
    layer = [torch.randn(3, 2 * 4, generator=g, dtype=torch.float64),
             torch.randn(3, 2 * 4, generator=g, dtype=torch.float64),
             torch.randn(2, 4, generator=g, dtype=torch.float64),
             torch.randn(2, 4, generator=g, dtype=torch.float64),
             torch.randn(4, generator=g, dtype=torch.float64)]
    looped = stored.clone()
    looped.fill_diagonal_(True)
    z = (x @ layer[0]).view(6, 2, 4)
    want = (_dense_gat_layer(looped, z, layer[2], layer[3])
            + (x @ layer[1]).view(6, 2, 4)).mean(1) + layer[4]
    assert torch.allclose(model.forward([layer], x), want)


def test_step_work_by_hand():
    dims, heads = [3, 4, 2], 2  # hidden: 2 heads of 2; output: 2 heads of 2, averaged
    counts = harness.arch_module("work", {"arch": "gat"})
    train = counts.step_work(dims, N, NNZ, train=True, heads=heads)
    agg = train["aggregation"]
    structure = 6 * 4 + 5 * 4  # int32 columns and row pointers
    # per layer: the softmax, a product a head on A, then on Aᵀ, the SDDMM,
    # the softmax's backward
    assert len(agg) == 2 * (1 + 2 + 2 + 1 + 1)
    assert (agg[0].flops, agg[0].bytes) == (4 * 6 * 2, structure + (6 * 2 + 2 * 4 * 2) * 4)
    assert all(w == work.spmm(N, N, NNZ, 2) for w in agg[1:5])
    assert agg[5] == train["sddmm"][0] and len(train["sddmm"]) == 2
    assert agg[5].flops == 2 * 6 * 2 * 2
    assert agg[5].bytes == structure + 2 * 4 * 2 * 2 * 4 + 6 * 2 * 4  # ȳ, z, then ᾱ
    assert (agg[6].flops, agg[6].bytes) == (6 * 6 * 2,
                                            structure + (2 * 6 * 2 + 2 * 4 * 2) * 4)
    # x W and x W_res, their weight gradients, and layer 2's two input gradients
    assert sorted(w.flops for w in train["dense"]) == sorted(
        [2 * 4 * 3 * 4] * 4 + [2 * 4 * 4 * 4] * 6)
    infer = counts.step_work(dims, N, NNZ, train=False, heads=heads)
    assert len(infer["aggregation"]) == 2 * (1 + 2) and infer["sddmm"] == []


def test_nnz_counts_a_plus_i():
    from h100bench.data import Graph

    # rows 0: {0, 2}, 1: {}, 2: {1}: one diagonal entry
    g = Graph(torch.tensor([0, 2, 2, 3]), torch.tensor([0, 2, 1]), torch.ones(3), 3)
    assert harness.arch_module("work", {"arch": "gat"}).nnz(g) == 2 + 3


@pytest.mark.parametrize("cell,driver,config", [
    ("gat.train.kron16", "train_gat_full_graph", "gat"),
    ("kron16.spmm-k128", "spmm_plan", "gcn"),
])
def test_the_cells_resolve_to_their_files(cell, driver, config):
    entry, workload, body = harness.cell_files(cell, BENCH)
    assert workload["driver"] == driver and entry["config"] == body["name"] == config
    module = harness.load_module(harness.HERE / "drivers" / f"{driver}.py")
    assert all(hasattr(module, name) for name in ("run", "readings", "Cell", "FAULTS"))
    e2e = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell, BENCH)}
    assert e2e == ({"train_step_ms", "setup_s"} if "train" in cell
                   else {"forward_ms", "forward_p95_ms", "setup_s"})
    for m in BENCH["per_layer"]:
        if harness.applies(m, cell, BENCH):
            assert (harness.HERE / "layers" / f"{m['name']}.py").is_file()


def test_the_attention_metrics_read_the_program_spans():
    from h100bench import spans as program

    names = ("attn_ms.train", "sddmm_ms.train", "sddmm_roofline.train")
    for name in names:
        m = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["gat.train.kron16"] and m["source"] == "program_span"
    read = {n: harness.load_module(harness.HERE / "layers" / f"{n}.py").read for n in names}
    stat = lambda device_s: program.SpanStats(2, device_s, 0.0, 0, 0)
    by = {"agg.attention": stat(0.002), "agg.attention_backward": stat(0.004),
          "agg.sddmm": stat(0.010)}

    class Layer:
        steps, sddmm_bound_s = 2, 0.0005
        spans = program.Spans(1.0, by, 0.0)

    assert read["attn_ms.train"](Layer) == pytest.approx(3.0)
    assert read["sddmm_ms.train"](Layer) == pytest.approx(5.0)
    assert read["sddmm_roofline.train"](Layer) == pytest.approx(10.0)
    Layer.spans = program.Spans(1.0, {}, 0.0)  # a program without the ranges
    assert all(r(Layer) is None for r in read.values())
    del Layer.spans  # the layer object of another driver
    assert all(r(Layer) is None for r in read.values())
