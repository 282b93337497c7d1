"""GraphSAGE-max's work: the max SpMM over ``A`` at each layer's input
width (with its winners, three outputs, in a train step), two products a
layer, and in a train step the two weight gradients, and for every layer
but the first the two input gradients and the max's backward."""
from h100bench.work import matmul, max_backward, spmm


def nnz(graph) -> int:
    return graph.nnz


def step_work(dims, n, nnz, train):
    agg, dense = [], []
    for layer, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        dense += [matmul(n, d_in, d_out), matmul(n, d_in, d_out)]
        agg.append(spmm(n, n, nnz, d_in, outputs=3 if train else 1))
        if train:  # the weight gradients of W_self and W_neigh
            dense += [matmul(d_in, n, d_out), matmul(d_in, n, d_out)]
        if train and layer > 0:  # through W_self, through W_neigh, then the max
            dense += [matmul(n, d_out, d_in), matmul(n, d_out, d_in)]
            agg.append(max_backward(n, n, d_in))
    return {"aggregation": agg, "dense": dense}
