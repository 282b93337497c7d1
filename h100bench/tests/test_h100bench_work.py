"""The work counts against counts made by hand on a tiny graph."""
import pytest

from h100bench import harness, work
from h100bench.peaks import H100_SXM, peaks_for

# 4 nodes, 6 stored entries, k = 2
N, NNZ = 4, 6


def arch(name):
    return harness.arch_module("work", {"arch": name})


def test_spmm_counts_the_csr_x_and_the_outputs_once():
    w = work.spmm(N, N, NNZ, 2)
    assert w.flops == 2 * 6 * 2
    # values and columns 6 * (4 + 4), row pointers 5 * 4, x 4 * 2 * 4, y 4 * 2 * 4
    assert w.bytes == 48 + 20 + 32 + 32
    assert work.spmm(N, N, NNZ, 2, outputs=3).bytes == 48 + 20 + 32 + 3 * 32


def test_max_backward_reads_three_and_writes_one():
    w = work.max_backward(N, N, 2)
    assert w.flops == 2 * 4 * 2
    assert w.bytes == 3 * 32 + 32


def test_matmul():
    w = work.matmul(4, 3, 2)
    assert w.flops == 2 * 4 * 3 * 2
    assert w.bytes == (12 + 6 + 8) * 4


def test_gcn_step_by_hand():
    dims = [3, 2, 1]
    train = arch("gcn").step_work(dims, N, NNZ, train=True)
    # forward SpMM at each layer's output width, and each again on the transpose
    assert [w.flops for w in train["aggregation"]] == [24, 24, 12, 12]
    # x W per layer, the weight gradients, the input gradient of layer 2 only
    assert sorted(w.flops for w in train["dense"]) == sorted(
        [2 * 4 * 3 * 2, 2 * 3 * 4 * 2, 2 * 4 * 2 * 1, 2 * 2 * 4 * 1, 2 * 4 * 1 * 2])
    infer = arch("gcn").step_work(dims, N, NNZ, train=False)
    assert [w.flops for w in infer["aggregation"]] == [24, 12]
    assert len(infer["dense"]) == 2


def test_sage_max_step_by_hand():
    dims = [3, 2, 1]
    train = arch("sage-max").step_work(dims, N, NNZ, train=True)
    agg = train["aggregation"]
    # the argmax SpMM at each layer's input width (three outputs), and the
    # max backward of layer 2 only (layer 1's input is the features)
    assert [w.flops for w in agg] == [2 * 6 * 3, 2 * 6 * 2, 2 * 4 * 2]
    assert agg[0].bytes == 48 + 20 + 4 * 3 * 4 + 3 * 4 * 3 * 4
    # two products a layer forward, two weight gradients, two input gradients at layer 2
    assert len(train["dense"]) == 2 * 2 + 2 * 2 + 2
    infer = arch("sage-max").step_work(dims, N, NNZ, train=False)
    assert infer["aggregation"][0].bytes == 48 + 20 + 4 * 3 * 4 + 4 * 3 * 4


def test_bound_is_the_larger_of_compute_and_memory():
    w = work.Work(67e12, 1.0)
    assert w.bound_s(H100_SXM) == pytest.approx(1.0)
    w = work.Work(1.0, 3.35e12)
    assert w.bound_s(H100_SXM) == pytest.approx(1.0)
    assert work.bound_s([w, w], H100_SXM) == pytest.approx(2.0)


def test_nnz_by_hand():
    import torch

    from h100bench.data import Graph

    # rows 0: {0, 2}, 1: {}, 2: {1}: one diagonal entry
    g = Graph(torch.tensor([0, 2, 2, 3]), torch.tensor([0, 2, 1]), torch.ones(3), 3)
    assert arch("sage-max").nnz(g) == 3
    assert arch("gcn").nnz(g) == 2 + 3  # off-diagonal entries plus one a node


def test_peaks_by_card_name():
    assert peaks_for("NVIDIA H100 80GB HBM3") is H100_SXM
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="H100 SXM"):
            peaks_for(other)
