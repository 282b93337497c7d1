"""GAT's work, ``heads`` heads a layer: per head an SpMM over ``A + I`` at
the head's width (the hidden layers' width over the heads, the output
layer's whole), and in a train step the same again over ``Aᵀ`` and the
SDDMM of the attention gradient; the edge softmax's passes; the products
``x W`` and ``x W_res``, their weight gradients, and the input gradients
of every layer but the first.

Counted by operation, as ``work/__init__.py`` sets out:

* the SDDMM reads the CSR structure (int32 columns and row pointers) and
  ``ȳ`` and ``z`` (``[n, H C]`` each) once and writes ``ᾱ`` (``[nnz, H]``)
  once, ``2 nnz H C`` FLOPs;
* the softmax forward reads the structure and the two score tables
  (``[n, H]``) once and writes ``α`` once, 4 operations an entry and head
  (add, LeakyReLU, subtract the row's maximum and exponentiate, divide);
  its backward reads ``α`` and ``ᾱ`` and writes the two score gradients,
  6 operations an entry and head.

The score products ``z a`` (``2 n H C`` each) are elementwise work and not
counted.
"""
from h100bench.work import F32, I32, Work, matmul, spmm


def nnz(graph) -> int:
    """Stored entries of ``A + I``: the off-diagonal entries plus one per
    node."""
    import torch

    rows = torch.repeat_interleave(torch.arange(graph.n, device=graph.indptr.device),
                                   graph.indptr[1:] - graph.indptr[:-1])
    return int((rows != graph.indices).sum()) + graph.n


def _structure(n: int, nnz: int) -> int:
    return nnz * I32 + (n + 1) * I32


def sddmm(n: int, nnz: int, heads: int, width: int) -> Work:
    return Work(2.0 * nnz * heads * width,
                _structure(n, nnz) + 2 * n * heads * width * F32 + nnz * heads * F32)


def softmax(n: int, nnz: int, heads: int, backward: bool = False) -> Work:
    if backward:
        return Work(6.0 * nnz * heads,
                    _structure(n, nnz) + (2 * nnz * heads + 2 * n * heads) * F32)
    return Work(4.0 * nnz * heads, _structure(n, nnz) + (nnz * heads + 2 * n * heads) * F32)


def _width(dims, layer: int, heads: int) -> int:
    """A head's width in ``layer``: the output layer's whole, a hidden
    layer's over the heads."""
    d_out = dims[layer + 1]
    return d_out if layer == len(dims) - 2 else d_out // heads


def step_work(dims, n, nnz, train, heads=1):
    """The aggregation (SpMMs, softmax and, training, the SDDMM), the dense
    products, and the SDDMMs alone (``"sddmm"``, part of the aggregation)."""
    agg, dense, sddmms = [], [], []
    for layer, d_in in enumerate(dims[:-1]):
        width = _width(dims, layer, heads)
        out = heads * width
        dense += [matmul(n, d_in, out), matmul(n, d_in, out)]  # x W, x W_res
        agg.append(softmax(n, nnz, heads))
        agg += [spmm(n, n, nnz, width)] * heads
        if train:
            agg += [spmm(n, n, nnz, width)] * heads  # on Aᵀ
            sddmms.append(sddmm(n, nnz, heads, width))
            agg += [sddmms[-1], softmax(n, nnz, heads, backward=True)]
            dense += [matmul(d_in, n, out), matmul(d_in, n, out)]
        if train and layer > 0:
            dense += [matmul(n, out, d_in), matmul(n, out, d_in)]
    return {"aggregation": agg, "dense": dense, "sddmm": sddmms}
