"""GraphSAGE with the element-wise neighbour max (Hamilton et al. 2017,
without the pooling MLP): ``act(x W_self + max_nbr(x) W_neigh + b)`` over
the raw adjacency; the backward scatters to each maximum's winner."""
from h100bench.reference import gnn


class Model(gnn.Model):
    def prepare(self, a):
        self.a = a

    def layer(self, p, h):
        w_self, w_neigh, b = p
        return self.matmul(h, w_self) + self.matmul(gnn.Max.apply(h, self.a), w_neigh) + b
