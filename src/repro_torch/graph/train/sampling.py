"""Neighbor-sampled mini-batching: subgraph extraction + GraphSAGE fan-out.

Full-graph training keeps one resident adjacency and aggregates every node
each step; GraphSAGE's original regime instead trains on *mini-batches*:
pick seed nodes, sample a bounded fan-out of neighbors per hop, and run
the forward/backward on the induced subgraph only.  Both halves live on
the host format:

* :func:`subgraph` — induced-subgraph extraction on :class:`CSRMatrix`
  (vectorised gather + relabel, no Python per-edge loop), preserving edge
  weights exactly;
* :func:`sample_neighbors` — the fan-out sampler: per hop, each frontier
  node draws at most ``fanout`` in-neighbors without replacement, the
  union becomes the batch's node set (seeds first), and the batch carries
  the induced adjacency over that set.

Determinism is the point of the ``seed`` parameter: the same
``(seeds, fanouts, seed)`` triple reproduces the same subgraph bit for
bit, so its content hash matches and re-admission to a serving
:class:`~repro_torch.serving.registry.MatrixRegistry` is free — epochs after
the first pay zero preprocessing (the admit-once/multiply-many asymmetry,
per batch).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import COOMatrix, CSRMatrix, csr_from_coo

__all__ = ["subgraph", "sample_neighbors", "SampledSubgraph"]


def _row_entries(csr: CSRMatrix, rows: np.ndarray):
    """All stored entries of ``rows``: (local_row, col, val), vectorised."""
    counts = csr.row_nnz()[rows]
    total = int(counts.sum())
    if total == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, np.zeros(0, dtype=csr.data.dtype)
    local = np.repeat(np.arange(rows.size), counts)
    base = np.repeat(csr.indptr[rows], counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    flat = base + within
    return local, csr.indices[flat], csr.data[flat]


def subgraph(csr: CSRMatrix, nodes) -> CSRMatrix:
    """Induced subgraph of a square adjacency on ``nodes``.

    ``nodes`` (global ids, duplicates dropped keeping first occurrence)
    become local ids 0..m-1 in the given order; the result keeps exactly
    the stored entries whose row AND column are both in the set, with
    their weights bit-identical to the parent — so local degrees equal
    the count of in-set parent neighbors, and repeated node sets produce
    content-hash-identical subgraphs.
    """
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"adjacency must be square, got {csr.shape}")
    nodes = np.asarray(nodes, dtype=np.int64).ravel()
    if nodes.size and (nodes.min() < 0 or nodes.max() >= csr.shape[0]):
        raise ValueError(f"node ids outside [0, {csr.shape[0]})")
    _, first = np.unique(nodes, return_index=True)
    nodes = nodes[np.sort(first)]
    m = nodes.size
    lookup = np.full(csr.shape[1], -1, dtype=np.int64)
    lookup[nodes] = np.arange(m)
    row_l, col_g, vals = _row_entries(csr, nodes)
    keep = lookup[col_g] >= 0
    return csr_from_coo(
        COOMatrix(row_l[keep], lookup[col_g[keep]], vals[keep], (m, m)),
        sum_duplicates=False,
    )


@dataclasses.dataclass
class SampledSubgraph:
    """One mini-batch: node set (seeds first) + induced adjacency."""

    nodes: np.ndarray  # int64[m] global ids; nodes[:n_seeds] are the seeds
    n_seeds: int
    adj: CSRMatrix  # [m, m] induced adjacency in local ids

    def seed_mask(self) -> np.ndarray:
        """f32[m] indicator of the seed rows — the loss mask: supervision
        applies to seeds only, the sampled context is support."""
        mask = np.zeros(self.nodes.size, dtype=np.float32)
        mask[: self.n_seeds] = 1.0
        return mask


def sample_neighbors(
    csr: CSRMatrix,
    seeds,
    fanouts,
    *,
    seed: int = 0,
) -> SampledSubgraph:
    """GraphSAGE fan-out sampling: seeds + ≤``fanouts[h]`` in-neighbors/hop.

    Hop ``h`` expands the current frontier: every frontier node draws at
    most ``fanouts[h]`` of its stored in-neighbors (without replacement,
    uniformly over the stored pattern), newly-seen nodes join the node
    set and form the next frontier.  The batch adjacency is the *induced*
    subgraph over the final node set — a superset of the sampled edge
    tree, so aggregation sees every in-set edge (one SpMM, no per-hop
    masking).  Node count is bounded by
    ``len(seeds) * prod(1 + fanouts)``; identical ``(seeds, fanouts,
    seed)`` reproduce the identical batch.
    """
    nodes = np.asarray(seeds, dtype=np.int64).ravel()
    _, first = np.unique(nodes, return_index=True)
    nodes = nodes[np.sort(first)]
    n_seeds = nodes.size
    if n_seeds == 0:
        raise ValueError("need at least one seed node")
    rng = np.random.default_rng(seed)
    seen = set(nodes.tolist())
    frontier = nodes
    order = [nodes]
    for fanout in fanouts:
        if fanout < 1 or frontier.size == 0:
            break
        picked = []
        for u in frontier:
            nbrs, _ = csr.row_slice(int(u))
            if nbrs.size == 0:
                continue
            if nbrs.size > fanout:
                nbrs = rng.choice(nbrs, size=fanout, replace=False)
            picked.extend(int(v) for v in nbrs)
        fresh = [v for v in dict.fromkeys(picked) if v not in seen]
        seen.update(fresh)
        frontier = np.asarray(fresh, dtype=np.int64)
        if fresh:
            order.append(frontier)
    nodes = np.concatenate(order)
    return SampledSubgraph(nodes=nodes, n_seeds=n_seeds, adj=subgraph(csr, nodes))
