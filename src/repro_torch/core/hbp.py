"""The Hash-Based Partition (HBP) format — faithful construction (Fig. 2).

This module reproduces the paper's storage format with its exact GPU
semantics and serves as the reference the tile format
(:mod:`repro_torch.core.tile`) and the kernels are validated against.

Components (paper §III-A):

* ``col`` / ``data``       — nonzeros of each block stored adjacently, in
  jagged column-major order over each warp's rows (no zero padding).
* ``add_sign``             — distance from a nonzero to the next nonzero of
  the *same row* inside the block; ``-1`` marks the last one.
* ``zero_row``             — ``-1`` for all-zero rows, else the number of
  zero rows preceding it inside its warp (so thread ``q`` can locate its
  first element without padding).
* ``begin_nnz``            — offset of each block's first nonzero (the
  role CSR's ``ptr`` plays, but per block).
* ``group_ptr``            — offset of each (block, warp-group)'s storage
  (the ``begin_ptr`` of Algorithm 3).
* ``output_hash``          — ``output_hash[slot] = original row``; the table
  index *is* the execution order, writes go to the pre-hash position.

Note on Algorithm 3: as printed, ``while add_sign[j] > 0`` would skip the
final element of every row (its ``add_sign`` is ``-1``).  We implement the
evidently intended do-while semantics — process the element, then follow
``add_sign`` if positive — and record the pseudocode off-by-one in
DESIGN.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .formats import CSRMatrix
from .hash import HashParams, sample_params
from .partition import Partition2D, PartitionConfig
from .reorder import REORDER_METHODS

__all__ = ["HBPMatrix", "build_hbp", "hbp_spmv_reference"]


@dataclasses.dataclass
class HBPMatrix:
    """Faithful HBP container (host-side arrays, GPU layout semantics)."""

    col: np.ndarray        # int64[nnz]  global column ids, jagged col-major
    data: np.ndarray       # float[nnz]
    add_sign: np.ndarray   # int64[nnz]  step to next element of same row, -1 at end
    zero_row: np.ndarray   # int64[nbr, nbc, row_block]
    begin_nnz: np.ndarray  # int64[nbr*nbc + 1]
    group_ptr: np.ndarray  # int64[nbr, nbc, groups_per_block] storage offsets
    output_hash: np.ndarray  # int64[nbr, nbc, row_block]  slot -> original local row
    group_nnz_rows: np.ndarray  # int64[nbr, nbc, groups_per_block] nonzero rows per group
    shape: tuple
    cfg: PartitionConfig
    warp: int
    hash_params: Dict[int, HashParams]  # per row-block sampled (a, c)

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def grid(self):
        return self.cfg.grid(self.shape)


def _jagged_order(row_pos: np.ndarray, k: np.ndarray, group: np.ndarray) -> np.ndarray:
    """Stable order by (group, k, row position): jagged column-major."""
    return np.lexsort((row_pos, k, group))


def build_hbp(
    csr: CSRMatrix,
    cfg: PartitionConfig | None = None,
    *,
    warp: int = 32,
    method: str = "hash",
) -> HBPMatrix:
    """Convert CSR → HBP (paper §III-B "format conversion").

    ``method`` selects the reordering: "hash" (the paper), "sort2d", "dp2d"
    or "none" — the same format built on a different permutation, which is
    how the preprocessing benchmark compares strategies like-for-like.
    """
    from repro_torch import obs

    cfg = cfg or PartitionConfig()
    with obs.span("admit.build_hbp", method=method, nnz=csr.nnz, warp=warp):
        return _build_hbp_impl(csr, cfg, warp, method)


def _build_hbp_impl(
    csr: CSRMatrix, cfg: PartitionConfig, warp: int, method: str
) -> HBPMatrix:
    part = Partition2D.build(csr, cfg)
    nbr, nbc = part.grid
    R = cfg.row_block
    gpb = R // warp  # warp groups per block

    reorder = REORDER_METHODS[method]

    col_out = np.empty(csr.nnz, dtype=np.int64)
    data_out = np.empty(csr.nnz, dtype=csr.data.dtype)
    add_out = np.empty(csr.nnz, dtype=np.int64)
    zero_row = np.full((nbr, nbc, R), -1, dtype=np.int64)
    group_ptr = np.zeros((nbr, nbc, gpb), dtype=np.int64)
    out_hash = np.zeros((nbr, nbc, R), dtype=np.int64)
    group_nzr = np.zeros((nbr, nbc, gpb), dtype=np.int64)
    hash_params: Dict[int, HashParams] = {}

    for bi in range(nbr):
        lo = bi * R
        hi = min(lo + R, csr.n_rows)
        n_local = hi - lo
        # per-row nnz inside each column block of this row block
        counts = np.zeros((R, nbc), dtype=np.int64)
        counts[:n_local] = part.counts[lo:hi]
        if method == "hash":
            params = sample_params(counts[counts > 0], table_size=R)
            hash_params[bi] = params
        for bj in range(nbc):
            base = part.begin_nnz[bi * nbc + bj]
            nnz_rows = counts[:, bj]
            if method == "hash":
                perm = REORDER_METHODS["hash"](nnz_rows, hash_params[bi])
            else:
                perm = reorder(nnz_rows)
            out_hash[bi, bj] = perm
            nnz_hashed = nnz_rows[perm]

            # zero_row: -1 for empty rows, else #zero rows before it in warp
            z = (nnz_hashed == 0).reshape(gpb, warp)
            zcum = np.cumsum(z, axis=1) - z  # exclusive prefix count
            zr = np.where(z, -1, zcum).reshape(-1)
            zero_row[bi, bj] = zr
            group_nzr[bi, bj] = (~z).sum(axis=1)

            blk_nnz = int(nnz_hashed.sum())
            if blk_nnz == 0:
                group_ptr[bi, bj] = base
                continue

            # entries of this block in block-row-major order, then reorder
            # rows by the permutation and emit jagged column-major.
            rows, cols, vals = part.block_entries(bi, bj)
            inv = np.empty(R, dtype=np.int64)
            inv[perm] = np.arange(R)
            row_pos = inv[rows]  # position of each entry's row in hashed order
            order_rm = np.lexsort((cols, row_pos))  # hashed-row major
            row_pos = row_pos[order_rm]
            cols = cols[order_rm] + bj * cfg.col_block  # store GLOBAL col
            vals = vals[order_rm]
            # k = index of entry within its row
            starts = np.zeros(R + 1, dtype=np.int64)
            np.cumsum(nnz_hashed, out=starts[1:])
            k = np.arange(blk_nnz) - starts[row_pos]
            grp = row_pos // warp
            jperm = _jagged_order(row_pos, k, grp)
            jpos = np.empty(blk_nnz, dtype=np.int64)
            jpos[jperm] = np.arange(blk_nnz)
            # add_sign: jagged distance to the next entry of the same row
            add = np.full(blk_nnz, -1, dtype=np.int64)
            same_row = row_pos[:-1] == row_pos[1:]
            add[:-1][same_row] = jpos[1:][same_row] - jpos[:-1][same_row]
            sl = slice(base, base + blk_nnz)
            col_out[sl] = cols[jperm]
            data_out[sl] = vals[jperm]
            add_out[sl] = add[jperm]
            # group storage offsets: cumsum of per-group nnz
            gsz = np.bincount(grp, weights=None, minlength=gpb)
            goff = np.zeros(gpb, dtype=np.int64)
            np.cumsum(gsz[:-1], out=goff[1:])
            group_ptr[bi, bj] = base + goff

    return HBPMatrix(
        col=col_out,
        data=data_out,
        add_sign=add_out,
        zero_row=zero_row,
        begin_nnz=part.begin_nnz,
        group_ptr=group_ptr,
        output_hash=out_hash,
        group_nnz_rows=group_nzr,
        shape=csr.shape,
        cfg=cfg,
        warp=warp,
        hash_params=hash_params,
    )


def hbp_spmv_reference(hbp: HBPMatrix, x: np.ndarray) -> np.ndarray:
    """Reference SpMV over the HBP format (Algorithm 3 semantics).

    Emulates the GPU execution: one warp per block, one thread per row slot,
    ``add_sign`` chases the jagged column-major storage.  Vectorised across
    the threads of a warp; the while-loop over ``add_sign`` is iterated to
    the longest row.  Partial vectors of blocks in the same block-row are
    summed — the "combine part" of Fig. 1.
    """
    nbr, nbc = hbp.grid
    R = hbp.cfg.row_block
    warp = hbp.warp
    gpb = R // warp
    y = np.zeros(hbp.shape[0], dtype=np.result_type(hbp.data, x))

    for bi in range(nbr):
        row_lo = bi * R
        n_local = min(R, hbp.shape[0] - row_lo)
        for bj in range(nbc):
            acc = np.zeros(R, dtype=y.dtype)  # per-slot partial results
            zr = hbp.zero_row[bi, bj]
            for g in range(gpb):
                q = np.arange(warp)
                zrg = zr[g * warp : (g + 1) * warp]
                active = zrg >= 0
                if not active.any():
                    continue
                # thread q's first element: group base + (q - #zero rows before)
                j = hbp.group_ptr[bi, bj, g] + (q - zrg)
                j = np.where(active, j, 0)
                sums = np.zeros(warp, dtype=y.dtype)
                alive = active.copy()
                while alive.any():
                    jj = j[alive]
                    sums[alive] += hbp.data[jj] * x[hbp.col[jj]]
                    step = hbp.add_sign[jj]
                    cont = step > 0
                    nxt = np.where(cont, j[alive] + step, j[alive])
                    j[alive] = nxt
                    alive[np.nonzero(alive)[0][~cont]] = False
                acc[g * warp : (g + 1) * warp] = sums
            # combine: write back through output_hash (pre-hash positions)
            perm = hbp.output_hash[bi, bj]
            contrib = np.zeros(R, dtype=y.dtype)
            contrib[perm] = acc  # slot s computed row perm[s]
            y[row_lo : row_lo + n_local] += contrib[:n_local]
    return y
