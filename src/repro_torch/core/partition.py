"""2D partitioning of sparse matrices (paper §III-A).

The matrix is split into ``row_block × col_block`` tiles.  Column
partitioning bounds the vector segment a block touches so it fits fast
memory (GPU shared memory in the paper); row partitioning bounds the
scope of the hash reordering.

The paper sets ``col_block = 4096`` (a vector segment of 4K doubles fits a
warp's shared-memory budget) and ``row_block = 512``.  A 4096-element f32
segment is 16 KiB, well inside one Hopper block's shared memory; we keep
the paper's defaults and expose them as knobs.

:func:`count_block_nnz` is the vectorised equivalent of the per-thread
counting loop in Algorithm 2: for every row it locates the column-block
boundaries inside the row's sorted column indices with a ``searchsorted``,
which yields the per-(row, col-block) nonzero counts in one shot.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .formats import CSRMatrix

__all__ = [
    "PartitionConfig",
    "count_block_nnz",
    "block_entry_order",
    "Partition2D",
    "enumerate_configs",
]


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    row_block: int = 512  # paper: N = 512 (reorder scope)
    col_block: int = 4096  # paper: M = 4096 (vector-segment length)
    # TPU tile geometry (see kernels/hbp_spmv.py): rows per group = sublanes,
    # tile width = lanes of one VREG.
    group: int = 8
    lane: int = 128

    def grid(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        n_rows, n_cols = shape
        return (
            -(-n_rows // self.row_block),
            -(-n_cols // self.col_block),
        )


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def enumerate_configs(
    shape: Tuple[int, int],
    *,
    row_blocks: Tuple[int, ...] = (256, 512),
    col_blocks: Tuple[int, ...] = (1024, 4096),
    groups: Tuple[int, ...] = (8,),
    lanes: Tuple[int, ...] = (8, 32, 128),
) -> list:
    """Candidate tile geometries for a measured autotune search.

    This is the search-space hook the serving autotuner
    (:mod:`repro.serving.autotune`) enumerates and times.  Candidates are
    clipped to the matrix: a row/column block larger than the (power-of-two
    padded) dimension only adds padding, so oversized values collapse onto
    the clipped one and duplicates are dropped, keeping the measured search
    proportional to the matrix, not to the nominal grid.  ``group`` must
    divide ``row_block`` (tile rows per group sit in the sublane dimension);
    invalid combinations are skipped.
    """
    n_rows, n_cols = shape
    row_cap = max(_next_pow2(n_rows), min(groups))
    col_cap = max(_next_pow2(n_cols), min(lanes))
    seen = set()
    out = []
    for rb in row_blocks:
        rb = min(rb, row_cap)
        for cb in col_blocks:
            cb = min(cb, col_cap)
            for g in groups:
                if rb % g:
                    continue
                for lane in lanes:
                    key = (rb, cb, g, lane)
                    if key in seen:
                        continue
                    seen.add(key)
                    out.append(
                        PartitionConfig(row_block=rb, col_block=cb, group=g, lane=lane)
                    )
    return out


def count_block_nnz(csr: CSRMatrix, cfg: PartitionConfig) -> np.ndarray:
    """Per-(row, col-block) nonzero counts — vectorised Algorithm 2.

    Returns ``counts`` of shape ``[n_rows, n_col_blocks]``.  This is the
    input of the nonlinear hash: ``counts[r, bj]`` is the nnz of row ``r``
    restricted to column block ``bj``.
    """
    n_rows, _ = csr.shape
    _, nbc = cfg.grid(csr.shape)
    if csr.nnz == 0:
        return np.zeros((n_rows, nbc), dtype=np.int64)
    # For every nonzero, its column block; then a 2D histogram over
    # (row, col_block).  Equivalent to the searchsorted loop but one pass.
    col_blk = csr.indices // cfg.col_block
    rows = np.repeat(np.arange(n_rows), csr.row_nnz())
    flat = rows * nbc + col_blk
    counts = np.bincount(flat, minlength=n_rows * nbc)
    return counts.reshape(n_rows, nbc)


def block_entry_order(csr: CSRMatrix, cfg: PartitionConfig) -> np.ndarray:
    """Stable order of nonzero entries grouped by (row_block, col_block).

    Returns a permutation ``perm`` over ``[0, nnz)`` such that
    ``indices[perm]`` enumerates entries block by block (row-block major,
    then column block), preserving row-major / column-sorted order within
    each block.  CSR entries are already sorted by (row, col), so a stable
    sort on the block id suffices — no comparison sort over full keys.
    """
    col_blk = csr.indices // cfg.col_block
    rows = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
    row_blk = rows // cfg.row_block
    _, nbc = cfg.grid(csr.shape)
    block_id = row_blk * nbc + col_blk
    return np.argsort(block_id, kind="stable")


@dataclasses.dataclass
class Partition2D:
    """A 2D-partitioned view of a CSR matrix.

    * ``counts[r, bj]`` — nnz of row r in column block bj (hash input).
    * ``begin_nnz[bi, bj]`` — offset of block (bi, bj)'s first entry in the
      block-ordered entry arrays (the paper's ``begin_nnz``; plays the role
      CSR's ``ptr`` plays, but per block).
    * ``entry_perm`` — permutation taking CSR entry order to block order.
    """

    csr: CSRMatrix
    cfg: PartitionConfig
    counts: np.ndarray  # int64[n_rows, nbc]
    begin_nnz: np.ndarray  # int64[nbr * nbc + 1]
    entry_perm: np.ndarray  # int64[nnz]

    @classmethod
    def build(cls, csr: CSRMatrix, cfg: PartitionConfig | None = None) -> "Partition2D":
        from repro_torch import obs

        cfg = cfg or PartitionConfig()
        with obs.span(
            "admit.partition",
            row_block=cfg.row_block,
            col_block=cfg.col_block,
            nnz=csr.nnz,
        ):
            counts = count_block_nnz(csr, cfg)
            nbr, nbc = cfg.grid(csr.shape)
            # per-block totals: sum counts over the rows of each row block
            n_rows = csr.n_rows
            pad_rows = nbr * cfg.row_block - n_rows
            padded = np.pad(counts, ((0, pad_rows), (0, 0)))
            block_tot = padded.reshape(nbr, cfg.row_block, nbc).sum(axis=1)
            begin = np.zeros(nbr * nbc + 1, dtype=np.int64)
            np.cumsum(block_tot.reshape(-1), out=begin[1:])
            perm = block_entry_order(csr, cfg)
        return cls(csr, cfg, counts, begin, perm)

    @property
    def grid(self) -> Tuple[int, int]:
        return self.cfg.grid(self.csr.shape)

    def block_nnz(self) -> np.ndarray:
        """nnz per block, shape [nbr, nbc] — the scheduler's cost signal."""
        nbr, nbc = self.grid
        return np.diff(self.begin_nnz).reshape(nbr, nbc)

    def block_rows(self, bi: int) -> Tuple[int, int]:
        lo = bi * self.cfg.row_block
        return lo, min(lo + self.cfg.row_block, self.csr.n_rows)

    def block_entries(self, bi: int, bj: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, local_cols, data) of block (bi, bj), row-major within block."""
        nbr, nbc = self.grid
        lo, hi = self.begin_nnz[bi * nbc + bj], self.begin_nnz[bi * nbc + bj + 1]
        idx = self.entry_perm[lo:hi]
        all_rows = np.repeat(np.arange(self.csr.n_rows), self.csr.row_nnz())
        rows = all_rows[idx] - bi * self.cfg.row_block
        cols = self.csr.indices[idx] - bj * self.cfg.col_block
        return rows, cols, self.csr.data[idx]
