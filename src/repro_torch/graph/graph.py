"""Graph construction for HBP-backed message passing.

A graph enters the library as its adjacency matrix: neighborhood
aggregation — the inner loop of every message-passing GNN — is exactly
``A @ X`` with a feature-matrix right-hand side, i.e. the multi-RHS SpMM
the HBP tile format already serves.  This module owns the host-side
construction: edge lists (or the R-MAT generator the paper's kron_g500
suite uses) become a :class:`~repro_torch.core.formats.CSRMatrix` adjacency with
optional self-loops and the degree-based normalizations GNN layers expect.

Conventions (row = destination): ``A[v, u] != 0`` means an edge u -> v, so
``(A @ X)[v]`` aggregates over v's in-neighbors — the message direction of
GCN/GraphSAGE.  For undirected graphs build with ``symmetric=True`` and
the distinction disappears.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import COOMatrix, CSRMatrix, csr_from_coo
from repro_torch.core.matrices import rmat

__all__ = [
    "graph_from_edges",
    "add_self_loops",
    "degrees",
    "normalize_adjacency",
    "rmat_graph",
    "power_law_graph",
]


def graph_from_edges(
    src,
    dst,
    *,
    n_nodes: int | None = None,
    weights=None,
    symmetric: bool = False,
    self_loops: bool = False,
    dedup: bool = True,
) -> CSRMatrix:
    """Edge list -> CSR adjacency (row = destination, col = source).

    ``weights=None`` builds a binary adjacency; with ``dedup`` repeated
    edges collapse to a single 1 (weighted duplicates always sum, the COO
    convention).  ``symmetric`` mirrors every edge; ``self_loops`` adds
    the diagonal afterwards (weight 1).
    """
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError(f"src/dst length mismatch: {src.size} vs {dst.size}")
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(f"edge endpoints outside [0, {n_nodes})")
    if weights is None:
        data = np.ones(src.size, dtype=np.float32)
    else:
        data = np.asarray(weights, dtype=np.float32).ravel()
        if data.shape != src.shape:
            raise ValueError("weights must match the edge count")
    row, col = dst, src  # aggregate INTO the destination row
    if symmetric:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
        data = np.concatenate([data, data])
    csr = csr_from_coo(COOMatrix(row, col, data, (n_nodes, n_nodes)))
    if weights is None and dedup:
        # binary graph: repeated (and mirrored-duplicate) edges are still one edge
        csr.data = np.minimum(csr.data, 1.0).astype(np.float32)
    if self_loops:
        csr = add_self_loops(csr)
    return csr


def add_self_loops(csr: CSRMatrix, weight: float = 1.0) -> CSRMatrix:
    """A + weight * I, replacing any existing diagonal (GCN's A-tilde).

    Replacing (not accumulating) keeps the call idempotent — renormalizing
    a graph that already carries self-loops does not double them."""
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"adjacency must be square, got {csr.shape}")
    coo = csr.to_coo()
    off = coo.row != coo.col
    row = np.concatenate([coo.row[off], np.arange(n)])
    col = np.concatenate([coo.col[off], np.arange(n)])
    data = np.concatenate(
        [coo.data[off], np.full(n, weight, dtype=coo.data.dtype)]
    )
    return csr_from_coo(COOMatrix(row, col, data, csr.shape))


def degrees(csr: CSRMatrix, *, weighted: bool = False) -> np.ndarray:
    """Per-row degree: in-neighbor count (or weighted row sum).

    The structural count is what mean-aggregation divides by; the weighted
    sum is the D of the GCN normalization."""
    if weighted:
        out = np.zeros(csr.n_rows, dtype=np.float64)
        np.add.at(out, np.repeat(np.arange(csr.n_rows), csr.row_nnz()), csr.data)
        return out
    return csr.row_nnz().astype(np.int64)


def normalize_adjacency(csr: CSRMatrix, kind: str = "sym") -> CSRMatrix:
    """Degree-normalize an adjacency matrix.

    * ``"sym"`` — ``D^{-1/2} A D^{-1/2}`` (GCN's symmetric normalization;
      D = weighted row sums, isolated nodes keep 0 rows);
    * ``"row"`` — ``D^{-1} A`` (row-stochastic: sum-aggregation over the
      result IS mean aggregation);
    * ``"none"`` — a copy, for API uniformity.
    """
    if kind == "none":
        return CSRMatrix(csr.indptr.copy(), csr.indices.copy(), csr.data.copy(), csr.shape)
    if kind not in ("sym", "row"):
        raise ValueError(f"unknown normalization {kind!r} (sym | row | none)")
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"adjacency must be square, got {csr.shape}")
    d = degrees(csr, weighted=True)
    with np.errstate(divide="ignore"):
        d_inv = np.where(d != 0, 1.0 / d, 0.0)
        d_inv_sqrt = np.sqrt(np.where(d > 0, d_inv, 0.0))
    rows = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
    if kind == "row":
        data = csr.data * d_inv[rows]
    else:
        data = csr.data * d_inv_sqrt[rows] * d_inv_sqrt[csr.indices]
    return CSRMatrix(csr.indptr.copy(), csr.indices.copy(), data.astype(np.float32), csr.shape)


def rmat_graph(
    n: int,
    avg_degree: float = 16.0,
    *,
    seed: int = 0,
    symmetric: bool = True,
    self_loops: bool = False,
) -> CSRMatrix:
    """Binary R-MAT (kron_g500-family) graph: power-law degrees, the
    skewed-row workload the nonlinear hash was built for.

    ``n`` rounds up to the next power of two (the R-MAT recursion depth).
    """
    g = rmat(n, int(n * avg_degree), seed=seed, symmetric=symmetric)
    g = CSRMatrix(g.indptr, g.indices, np.ones(g.nnz, dtype=np.float32), g.shape)
    if self_loops:
        g = add_self_loops(g)
    return g


def power_law_graph(
    n: int,
    avg_degree: float = 8.0,
    *,
    seed: int = 0,
    exponent: float = 1.2,
    symmetric: bool = True,
    self_loops: bool = False,
) -> CSRMatrix:
    """Power-law graph at an *exact* node count (R-MAT rounds to 2^k).

    Endpoints are sampled with Zipf-like popularity ``p(v) ∝ rank^-exponent``
    under a random rank assignment — a preferential-attachment-shaped
    degree profile on precisely ``n`` nodes, which is what the GNN
    acceptance tests pin (e.g. the 10k-node Cora-like graph).
    """
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree) // (2 if symmetric else 1)
    p = (1.0 + np.arange(n)) ** -exponent
    p /= p.sum()
    popularity = rng.permutation(n)  # which node gets which rank
    src = popularity[rng.choice(n, size=m, p=p)]
    dst = popularity[rng.choice(n, size=m, p=p)]
    keep = src != dst  # self-loops only by request, below
    return graph_from_edges(
        src[keep], dst[keep], n_nodes=n, symmetric=symmetric, self_loops=self_loops
    )
