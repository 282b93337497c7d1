"""GCN's work: an SpMM over ``Â`` at each layer's output width, and in a
train step the same again over ``Âᵀ``; the products ``x W``, the weight
gradients, and the input gradients of every layer but the first."""
from h100bench.work import matmul, spmm


def nnz(graph) -> int:
    """Stored entries of ``A + I``: the off-diagonal entries plus one per
    node."""
    import torch

    rows = torch.repeat_interleave(torch.arange(graph.n, device=graph.indptr.device),
                                   graph.indptr[1:] - graph.indptr[:-1])
    return int((rows != graph.indices).sum()) + graph.n


def step_work(dims, n, nnz, train):
    agg, dense = [], []
    for layer, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        dense.append(matmul(n, d_in, d_out))
        agg.append(spmm(n, n, nnz, d_out))
        if train:  # the transpose product and the weight gradient
            agg.append(spmm(n, n, nnz, d_out))
            dense.append(matmul(d_in, n, d_out))
        if train and layer > 0:
            dense.append(matmul(n, d_out, d_in))
    return {"aggregation": agg, "dense": dense}
