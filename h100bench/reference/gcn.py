"""GCN (Kipf & Welling 2017): ``act(Â (x W) + b)`` with
``Â = D^-1/2 (A + I) D^-1/2`` (the diagonal replaced by 1, D the row sums
of ``A + I``); the backward multiplies by ``Âᵀ``."""
from h100bench.reference import gnn


class Model(gnn.Model):
    def prepare(self, a):
        self.a = gnn.gcn_normalize(a)
        self.a_t = gnn.transpose(self.a)

    def layer(self, p, h):
        w, b = p
        return gnn.Sum.apply(self.matmul(h, w), self.a, self.a_t) + b
