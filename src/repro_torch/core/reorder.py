"""Row-reordering strategies and load-balance metrics (paper §III-B, §IV-A/B).

All strategies consume the per-row nonzero counts of one (row-block,
col-block) tile and return a permutation ``perm`` with ``perm[slot] =
original_row`` (the paper's ``output_hash``).  Rows executed by the same
warp (GPU) / packed into the same sublane group (TPU) are consecutive slots.

Strategies:

* :func:`hash_reorder_block` — the paper's nonlinear hash (O(rows), parallel).
* :func:`sort_reorder` — ``sort2D`` baseline: full comparison sort by nnz.
* :func:`dp_reorder` — ``DP2D`` baseline: the Regu2D dynamic-programming
  grouping (sort + O(n·G) DP choosing group boundaries that minimise padded
  work).  Its mandatory sort is the bottleneck the paper removes.
* :func:`identity_reorder` — no reordering (the plain 2D-partitioning
  baseline of Figs. 8/10).

Metrics:

* :func:`group_stddev` — Fig. 6's metric: std-dev of per-row nnz within each
  execution group (warp on GPU, sublane group on TPU).
* :func:`padding_waste` — the TPU-relevant cost: fraction of padded slots
  when each group is stored as a dense tile of width = group max.
"""
from __future__ import annotations

import numpy as np

from .hash import HashParams, hash_reorder

__all__ = [
    "identity_reorder",
    "hash_reorder_block",
    "sort_reorder",
    "dp_reorder",
    "group_stddev",
    "padding_waste",
    "REORDER_METHODS",
]


def identity_reorder(row_nnz: np.ndarray) -> np.ndarray:
    return np.arange(row_nnz.size, dtype=np.int64)


def hash_reorder_block(
    row_nnz: np.ndarray, params: HashParams | None = None
) -> np.ndarray:
    """The paper's method — see :mod:`repro.core.hash`."""
    return hash_reorder(row_nnz, params)


def sort_reorder(row_nnz: np.ndarray) -> np.ndarray:
    """sort2D baseline: comparison sort on the row nnz."""
    return np.argsort(row_nnz, kind="stable")


def dp_reorder(row_nnz: np.ndarray, *, group: int = 32, max_group: int | None = None) -> np.ndarray:
    """DP2D baseline (Regu2D): sort, then dynamic programming over group
    boundaries minimising the zero-padded storage cost.

    After sorting ascending, rows are split into contiguous groups of size at
    most ``max_group`` (default ``2*group``); a group of rows ``[i, j)`` costs
    ``(j - i_pad) * nnz[j-1]`` where every row is padded to the group max
    (``nnz[j-1]``, the largest since sorted).  DP finds the boundary set with
    minimum total padded cost.  The output permutation is the sorted order —
    the DP's value is the grouping, its *cost* is the sort + O(n·G) table,
    which is what the preprocessing benchmark measures.
    """
    order = np.argsort(row_nnz, kind="stable")
    nnz = np.asarray(row_nnz)[order]
    n = nnz.size
    max_group = max_group or 2 * group
    INF = np.inf
    best = np.full(n + 1, INF)
    best[0] = 0.0
    choice = np.zeros(n + 1, dtype=np.int64)
    for j in range(1, n + 1):
        lo = max(0, j - max_group)
        # group [i, j) padded to nnz[j-1]
        for i in range(lo, j):
            c = best[i] + (j - i) * nnz[j - 1]
            if c < best[j]:
                best[j] = c
                choice[j] = i
    # boundaries are implicit in the sorted order; the permutation is the
    # sorted order itself (groups are contiguous runs of it).
    return order


REORDER_METHODS = {
    "none": identity_reorder,
    "hash": hash_reorder_block,
    "sort2d": sort_reorder,
    "dp2d": dp_reorder,
}


def group_stddev(row_nnz: np.ndarray, perm: np.ndarray, *, group: int = 32) -> np.ndarray:
    """Per-group std-dev of nnz after reordering (Fig. 6's ordinate).

    ``group`` is the number of rows executed together: the warp width (32)
    on GPU; on TPU we also report it for the 8-row sublane groups.
    """
    nnz = np.asarray(row_nnz)[perm].astype(np.float64)
    pad = (-nnz.size) % group
    if pad:
        nnz = np.pad(nnz, (0, pad))
    return nnz.reshape(-1, group).std(axis=1)


def padding_waste(row_nnz: np.ndarray, perm: np.ndarray, *, group: int = 8) -> float:
    """Fraction of wasted (padded) slots when each ``group`` consecutive rows
    are stored as a dense tile of width ``max(nnz in group)``.

    This is the TPU analogue of warp divergence: on the GPU wasted work is
    idle lanes inside a warp; on the TPU it is zero-padded MAC slots inside
    an 8×128 tile.  Lower is better; 0 means perfectly homogeneous groups.
    """
    nnz = np.asarray(row_nnz)[perm].astype(np.int64)
    pad = (-nnz.size) % group
    if pad:
        nnz = np.pad(nnz, (0, pad))
    g = nnz.reshape(-1, group)
    padded = (g.max(axis=1) * group).sum()
    useful = g.sum()
    if padded == 0:
        return 0.0
    return float(1.0 - useful / padded)
