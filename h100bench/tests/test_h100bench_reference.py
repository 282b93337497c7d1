"""The plain reference against dense torch products, the max's documented
semantics included: ties to the lowest column, signed zeros, NaN, stored
zeros and empty rows."""
import math

import pytest
import torch

from h100bench import harness
from h100bench.reference import gnn

NAN = float("nan")


def csr_of(dense: torch.Tensor, stored: torch.Tensor) -> gnn.Csr:
    idx = stored.nonzero()
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(stored.sum(1), 0)
    return gnn.Csr(indptr, idx[:, 1], dense[stored], dense.shape[1])


def dense_max(dense, stored, x):
    """Row max of ``a * x`` over stored nonzero entries, the lowest winning
    column (+0 and -0 equal), the winner's value; NaN rows give idx -1."""
    n, k = dense.shape[0], x.shape[1]
    y = torch.zeros(n, k, dtype=x.dtype)
    idx = torch.full((n, k), -1, dtype=torch.int64)
    coeff = torch.zeros(n, k, dtype=x.dtype)
    for i in range(n):
        for c in range(k):
            terms = [(j, dense[i, j] * x[j, c]) for j in range(dense.shape[1])
                     if stored[i, j] and dense[i, j] != 0]
            if not terms:
                continue
            values = torch.stack([t for _, t in terms])
            if torch.isnan(values).any():
                y[i, c] = NAN
                continue
            top = values.max()
            if top == 0:  # +0 wins over -0
                top = torch.tensor(0.0 if any(not torch.signbit(v) for v in values
                                              if v == 0) else -0.0, dtype=x.dtype)
            y[i, c] = top
            j = min(j for j, t in terms if t == top)
            idx[i, c], coeff[i, c] = j, dense[i, j]
    return y, idx, coeff


@pytest.fixture
def case():
    dense = torch.zeros(7, 5)
    stored = torch.zeros(7, 5, dtype=torch.bool)
    for i, j, v in [(0, 0, 1.0), (0, 2, 2.0), (0, 4, 1.0), (1, 1, 1.0), (1, 3, 1.0),
                    (3, 0, 1.0), (3, 1, 1.0), (3, 2, 1.0), (3, 3, 1.0), (3, 4, 1.0),
                    (4, 2, 0.0), (5, 1, -1.0), (5, 4, -1.0), (6, 0, 1.0), (6, 3, 1.0)]:
        dense[i, j], stored[i, j] = v, True
    # row 2 empty, row 4 one stored zero; +0/-0, NaN and ties in x
    x = torch.tensor([[1.0, 0.0, -0.0], [1.0, -0.0, 0.0], [0.5, NAN, 2.0],
                      [1.0, 3.0, -1.0], [0.0, 1.0, 2.0]])
    return dense, stored, x


def test_max_matches_dense_bit_for_bit(case):
    dense, stored, x = case
    y, idx, coeff = gnn.spmm_max(csr_of(dense, stored), x)
    y_d, idx_d, coeff_d = dense_max(dense, stored, x)
    assert torch.equal(y.view(torch.int32), y_d.view(torch.int32))
    assert torch.equal(idx, idx_d) and torch.equal(coeff, coeff_d)
    assert math.isnan(y[0, 1]) and idx[0, 1] == -1  # NaN kept, no winner
    assert idx[2].tolist() == [-1, -1, -1] and y[2].tolist() == [0.0, 0.0, 0.0]  # empty
    assert idx[4].tolist() == [-1, -1, -1]  # a stored zero is no entry
    assert torch.signbit(y[5, 0]) and idx[5, 0] == 4  # -0 = max(-1, -0)
    assert not torch.signbit(y[5, 1]) and idx[5, 1] == 1  # +0 above -0, column 1 wins


def test_max_in_blocks_equals_one_block(case, monkeypatch):
    dense, stored, x = case
    whole = gnn.spmm_max(csr_of(dense, stored), x)
    monkeypatch.setattr(gnn, "_MAX_BLOCK", 4)
    blocked = gnn.spmm_max(csr_of(dense, stored), x)
    for a, b in zip(whole, blocked):
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.int64 else a.view(torch.int32),
                           b.view(torch.int64) if b.dtype == torch.int64 else b.view(torch.int32))


def test_sum_and_mean_match_dense(case):
    dense, stored, x = case
    x = torch.nan_to_num(x).double()
    a = csr_of(dense.double(), stored)
    assert torch.allclose(gnn.spmm_sum(a, x), dense.double() @ x)
    counts = stored.sum(1).clamp(min=1).double()[:, None]
    assert torch.allclose(gnn.spmm_mean(a, x), (dense.double() @ x) / counts)


def test_transpose_and_gcn_normalization_match_dense():
    g = torch.Generator().manual_seed(0)
    stored = torch.rand(9, 9, generator=g) < 0.3
    dense = stored.double()
    a = csr_of(dense, stored)
    t = gnn.transpose(a)
    x = torch.randn(9, 3, generator=g, dtype=torch.float64)
    assert torch.allclose(gnn.spmm_sum(t, x), dense.T @ x)
    a_hat = dense.clone()
    a_hat.fill_diagonal_(1.0)
    d = a_hat.sum(1)
    want = a_hat / torch.sqrt(d[:, None] * d[None, :])
    assert torch.allclose(gnn.spmm_sum(gnn.gcn_normalize(a), x), want @ x)


def test_max_backward_scatters_to_the_winner():
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    idx = torch.tensor([[1, -1], [1, 0]])
    coeff = torch.tensor([[2.0, 0.0], [0.5, 1.0]])
    got = gnn.scatter_max_grad(g, idx, coeff, 3)
    assert got.tolist() == [[0.0, 4.0], [2.0 + 1.5, 0.0], [0.0, 0.0]]


def test_train_step_gradient_matches_autograd_through_dense():
    g = torch.Generator().manual_seed(1)
    n = 12
    stored = torch.rand(n, n, generator=g) < 0.4
    sage_max = harness.arch_module("reference", {"arch": "sage-max"})
    model = sage_max.Model(*csr_of(stored.float(), stored)[:3], n, "float64")
    x = torch.randn(n, 3, generator=g, dtype=torch.float64)
    params = [(torch.randn(3, 4, generator=g, dtype=torch.float64),
               torch.randn(3, 4, generator=g, dtype=torch.float64),
               torch.randn(4, generator=g, dtype=torch.float64))]
    leaves = [t.clone().requires_grad_(True) for t in params[0]]
    out = model.forward([leaves], x)
    dense_agg = torch.stack([torch.stack([
        (x[stored[i], c].max() if stored[i].any() else torch.tensor(0.0, dtype=x.dtype))
        for c in range(3)]) for i in range(n)])
    want = x @ leaves[0] + dense_agg @ leaves[1] + leaves[2]
    assert torch.allclose(out, want)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10], dtype=torch.float32)
    assert gnn._tf32_round(t).tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
