"""GAT (Veličković et al. 2018, arXiv:1710.10903) as in DGL's ogbn-arxiv
example: multi-head attention over ``A + I`` with a linear residual, the
heads concatenated in the hidden layers and averaged in the output layer.

A layer of H heads of width C takes ``h: [n, d_in]``, ``W`` and ``W_res``
``[d_in, H C]``, ``a_src`` and ``a_dst`` ``[H, C]`` and a bias ``b``:

* ``z = h W`` as ``[n, H, C]``; ``s_src = sum_c z a_src``, ``s_dst = sum_c
  z a_dst``;
* for each stored ``(i, j)`` of ``A + I`` (row = destination, the
  diagonal replaced by self-loops): ``e = LeakyReLU_0.2(s_dst[i] +
  s_src[j])``, and ``alpha`` its softmax over row i's entries;
* ``y_i,h = sum_j alpha_ij,h z_j,h``;
* hidden: ``ReLU(concat_h y + h W_res + b)``; output: ``mean_h(y_h + (h
  W_res)_h) + b``.

:class:`Attention` is the aggregation with its backward written out from
those equations: ``z̄_h = alpha_hᵀ ȳ_h`` (a product over the transpose),
``alpha̅[(i, j), h] = ȳ_i,h · z_j,h`` (the SDDMM, gathered in edge blocks
so float64 fits on the card), the softmax's and the LeakyReLU's backward,
and the score gradients as sums over rows and over columns.  Dropout and
batch norm are left out, as the configuration says.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from h100bench.reference import gnn

NEGATIVE_SLOPE = 0.2
# elements of one edge block of the SDDMM's gathers: [entries, H, C]
_EDGE_BLOCK = 1 << 25


class Structure(NamedTuple):
    """``A + I``'s structure and its transpose's entry order."""

    a: gnn.Csr  # values unused
    rows: torch.Tensor  # i64[nnz]: each entry's row
    order_T: torch.Tensor  # Aᵀ's entry p is A's entry order_T[p]
    indptr_T: torch.Tensor


def self_looped(a: gnn.Csr) -> gnn.Csr:
    """``A + I``: every diagonal entry stored (value 1), the others kept."""
    n = a.n_rows
    rows = a.rows()
    off = rows != a.indices
    diag = torch.arange(n, device=rows.device)
    r = torch.cat([rows[off], diag])
    c = torch.cat([a.indices[off], diag])
    v = torch.cat([a.values[off], torch.ones(n, dtype=a.values.dtype, device=rows.device)])
    order = torch.argsort(r * a.n_cols + c)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return gnn.Csr(indptr, c[order], v[order], a.n_cols)


def structure(a: gnn.Csr) -> Structure:
    rows = a.rows()
    order_T = torch.argsort(a.indices, stable=True)
    indptr_T = torch.zeros(a.n_cols + 1, dtype=torch.int64, device=rows.device)
    indptr_T[1:] = torch.cumsum(torch.bincount(a.indices, minlength=a.n_cols), 0)
    return Structure(a, rows, order_T, indptr_T)


def _row_softmax(e: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax of ``e`` ([nnz, H]) over each row's entries, the row's
    maximum subtracted."""
    index = rows[:, None].expand_as(e)
    top = torch.full((n, e.shape[1]), float("-inf"), dtype=e.dtype, device=e.device)
    top = top.scatter_reduce(0, index, e, "amax", include_self=True)
    w = torch.exp(e - top[rows])
    total = torch.zeros((n, e.shape[1]), dtype=e.dtype, device=e.device).index_add(0, rows, w)
    return w / total[rows]


def _product(s: Structure, values: torch.Tensor, x: torch.Tensor, transpose: bool):
    """``A_v @ x`` or ``A_vᵀ @ x`` with A's structure and entry values ``values``."""
    a = s.a
    if transpose:
        m = gnn.Csr(s.indptr_T, s.rows[s.order_T], values[s.order_T].contiguous(), a.n_rows)
    else:
        m = gnn.Csr(a.indptr, a.indices, values.contiguous(), a.n_cols)
    return gnn.spmm_sum(m, x.contiguous())


def sddmm(s: Structure, dy: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``out[(i, j), h] = dy[i, h, :] . z[j, h, :]`` over every stored entry,
    ``[nnz, H]``, gathered in edge blocks of at most ``_EDGE_BLOCK``
    elements."""
    nnz = s.rows.numel()
    heads, width = dy.shape[1], dy.shape[2]
    out = torch.empty((nnz, heads), dtype=dy.dtype, device=dy.device)
    step = max(1, _EDGE_BLOCK // (heads * width))
    for e0 in range(0, nnz, step):
        e1 = min(e0 + step, nnz)
        out[e0:e1] = (dy[s.rows[e0:e1]] * z[s.a.indices[e0:e1]]).sum(-1)
    return out


class Attention(torch.autograd.Function):
    """``y[:, h] = alpha_h @ z[:, h]`` from ``z`` ``[n, H, C]`` and the
    scores ``[n, H]``."""

    @staticmethod
    def forward(ctx, z, s_src, s_dst, s: Structure):
        rows, cols = s.rows, s.a.indices
        pre = s_dst[rows] + s_src[cols]
        e = torch.where(pre > 0, pre, NEGATIVE_SLOPE * pre)
        alpha = _row_softmax(e, rows, s.a.n_rows)
        y = torch.stack([_product(s, alpha[:, h], z[:, h], False)
                         for h in range(z.shape[1])], dim=1)
        ctx.save_for_backward(z, pre, alpha)
        ctx.s = s
        return y

    @staticmethod
    def backward(ctx, dy):
        z, pre, alpha = ctx.saved_tensors
        s = ctx.s
        rows, cols, n = s.rows, s.a.indices, s.a.n_rows
        dz = torch.stack([_product(s, alpha[:, h], dy[:, h], True)
                          for h in range(z.shape[1])], dim=1)
        d_alpha = sddmm(s, dy, z)
        # softmax: de = alpha (d_alpha - sum over the row of alpha d_alpha)
        row_dot = torch.zeros((n, alpha.shape[1]), dtype=alpha.dtype,
                              device=alpha.device).index_add(0, rows, alpha * d_alpha)
        de = alpha * (d_alpha - row_dot[rows])
        d_pre = torch.where(pre > 0, de, NEGATIVE_SLOPE * de)
        zeros = torch.zeros((n, alpha.shape[1]), dtype=alpha.dtype, device=alpha.device)
        return dz, zeros.index_add(0, cols, d_pre), zeros.index_add(0, rows, d_pre), None


class Model(gnn.Model):
    def prepare(self, a):
        self.s = structure(self_looped(a))

    def forward(self, params, x):
        h = x
        for i, (w, w_res, a_src, a_dst, b) in enumerate(params):
            heads, width = a_src.shape
            z = self.matmul(h, w).view(-1, heads, width)
            y = Attention.apply(z, (z * a_src).sum(-1), (z * a_dst).sum(-1), self.s)
            y = y + self.matmul(h, w_res).view(-1, heads, width)
            if i == len(params) - 1:
                h = y.mean(1) + b
            else:
                h = torch.relu(y.reshape(-1, heads * width) + b)
        return h
