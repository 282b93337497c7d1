"""TPU-native HBP tile format (the hardware adaptation of Fig. 2).

On a GPU the HBP format removes warp divergence: the hash groups rows of
similar nnz so that the 32 threads of a warp finish together, and the
jagged ``add_sign`` storage avoids zero padding entirely.

A TPU core has no divergent threads to protect — its vector unit consumes
dense (8 sublanes × 128 lanes) registers and its grid is executed
*sequentially* by a scalar pipeline.  The paper's insight transfers as
follows (DESIGN.md §Hardware-adaptation):

* warp of 32 threads           → group of 8 rows (sublane dimension);
* divergence inside a warp     → zero padding inside an 8×``lane`` tile:
  each group is stored densely, padded to the group's max nnz.  The hash
  makes groups homogeneous, so padding (the TPU cost) is small — the same
  objective, a different cost model;
* ``add_sign`` pointer chasing → dense gather: a tile of column ids indexes
  the block's vector segment resident in VMEM;
* shared-memory vector segment → VMEM block, staged by ``BlockSpec``;
* the "combine part"           → revisited output blocks: the sequential
  grid lets consecutive tiles accumulate into the same output ref, fusing
  SpMV and combine (the fusion the paper wanted but atomics made too
  expensive on GPU — Discussion section).

The tile arrays produced here feed ``kernels/hbp_spmv.py`` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch import obs

from .formats import CSRMatrix
from .hash import sample_params
from .partition import Partition2D, PartitionConfig
from .reorder import REORDER_METHODS

__all__ = ["HBPTiles", "build_tiles", "tiles_from_arrays", "tuned_partition_config"]


@dataclasses.dataclass
class HBPTiles:
    """Packed 8×lane tiles, grid-ordered for the Pallas kernel.

    Tiles are sorted by (row_group, col_block, k) so that all tiles
    contributing to one output row group are consecutive — the kernel
    accumulates them into the output ref and writes it back once
    (fused combine).  ``first`` flags the first tile of each run.
    """

    data: np.ndarray  # f32[T, group, lane]
    cols: np.ndarray  # i32[T, group, lane]  LOCAL col within the col block
    rowgroup: np.ndarray  # i32[T]  global output row-group id (hashed order)
    colblock: np.ndarray  # i32[T]  column block id (selects the x segment)
    first: np.ndarray  # i32[T]  1 = first tile of its output row group
    perm: np.ndarray  # i64[padded_rows]  hashed position -> original row
    shape: Tuple[int, int]
    cfg: PartitionConfig
    n_rowgroups: int
    # i64[nnz]: CSR entry e sits at data.reshape(-1)[slot[e]] (None for
    # tiles rebuilt from arrays that carry no map)
    slot: Optional[np.ndarray] = None

    @property
    def n_tiles(self) -> int:
        return int(self.data.shape[0])

    def padded_rows(self) -> int:
        return self.n_rowgroups * self.cfg.group

    def nnz_utilization(self) -> float:
        """Useful fraction of tile slots (1 - padding waste)."""
        total = self.data.size
        return float(np.count_nonzero(self.data) / total) if total else 1.0

    # --- per-tile cost vectors (the plan-introspection inputs) -------------

    def tile_nnz(self) -> np.ndarray:
        """Stored entries per tile, ``i64[T]`` — each tile's useful payload.

        The kernel streams every tile at full ``group × lane`` width
        regardless, so ``tile_nnz / (group * lane)`` is the per-tile
        occupancy: the exact fraction of that tile's HBM traffic that was
        not padding.
        """
        if self.n_tiles == 0:
            return np.zeros(0, dtype=np.int64)
        return np.count_nonzero(
            self.data.reshape(self.n_tiles, -1), axis=1
        ).astype(np.int64)

    def tile_occupancy(self) -> np.ndarray:
        """Per-tile useful fraction of slots, ``f64[T]`` in (0, 1]."""
        slots = self.cfg.group * self.cfg.lane
        return self.tile_nnz() / float(slots)

    def rowgroup_costs(self) -> np.ndarray:
        """Tiles per output row group, ``i64[n_rowgroups]``.

        On the sequentially-executed TPU grid a row group's service time is
        proportional to the tiles it owns — this is the cost vector the
        imbalance gauges and the LPT competitive-ratio model consume.
        """
        return np.bincount(self.rowgroup, minlength=self.n_rowgroups).astype(
            np.int64
        )

    def block_costs(self) -> np.ndarray:
        """Tiles per (row-block, col-block) grid cell, flattened row-major.

        The schedule layer's unit of placement (paper §III-C): feeding this
        to :func:`repro.core.schedule.lpt_schedule` replays the competitive
        allocation and yields the modeled-vs-ideal makespan ratio.
        """
        gpb = self.cfg.row_block // self.cfg.group
        nbr = -(-self.n_rowgroups // gpb)
        nbc = -(-self.shape[1] // self.cfg.col_block)
        if self.n_tiles == 0:
            return np.zeros(nbr * nbc, dtype=np.int64)
        block_id = (self.rowgroup.astype(np.int64) // gpb) * nbc + self.colblock
        return np.bincount(block_id, minlength=nbr * nbc).astype(np.int64)


def build_tiles(
    csr: CSRMatrix,
    cfg: PartitionConfig | None = None,
    *,
    method: str = "hash",
) -> HBPTiles:
    """CSR → TPU tile format.

    Per (row-block, col-block): reorder rows with ``method`` (the paper's
    hash by default, "none" reproduces the plain 2D-partitioning baseline),
    cut the reordered rows into groups of ``cfg.group``, pad each group to
    ``ceil(max_nnz / lane)`` tiles of ``group × lane``, gather column ids
    local to the column block.  Padded slots carry ``col=0, data=0`` so the
    kernel's gather-multiply contributes nothing.  Each CSR entry's position
    is carried through the sorts into ``slot``, its flat index into ``data``:
    new values in CSR order are written into a copy of ``data`` without a
    rebuild (GAT's attention weights, :mod:`repro_torch.kernels.autodiff`).
    """
    cfg = cfg or PartitionConfig()
    with obs.span(
        "admit.build_tiles", method=method, n_rows=csr.shape[0], nnz=csr.nnz
    ) as sp:
        tiles = _build_tiles_impl(csr, cfg, method)
        sp.annotate(
            tiles=tiles.n_tiles, nnz_utilization=round(tiles.nnz_utilization(), 4)
        )
    if obs.enabled():
        obs.counter("admit.tile_builds").inc()
        obs.counter("admit.tiles_built").inc(tiles.n_tiles)
        obs.histogram("admit.nnz_utilization").observe(tiles.nnz_utilization())
        # padding is the TPU adaptation's cost model: zero slots streamed
        # from HBM for nothing — the quantity the hash exists to minimize
        obs.counter("admit.padded_slots").inc(
            tiles.data.size - int(np.count_nonzero(tiles.data))
        )
    return tiles


def _build_tiles_impl(csr: CSRMatrix, cfg: PartitionConfig, method: str) -> HBPTiles:
    part = Partition2D.build(csr, cfg)
    nbr, nbc = part.grid
    R, G, LANE = cfg.row_block, cfg.group, cfg.lane
    gpb = R // G  # row groups per row block

    reorder = REORDER_METHODS[method]

    tiles_data: list = []
    tiles_cols: list = []
    t_rowgroup: list = []
    t_colblock: list = []
    t_entries: list = []  # (CSR positions, flat slots in the unsorted stream)
    n_built = 0  # tiles packed so far, in packing order
    perm_global = np.empty(nbr * R, dtype=np.int64)

    for bi in range(nbr):
        lo = bi * R
        hi = min(lo + R, csr.n_rows)
        counts = np.zeros((R, nbc), dtype=np.int64)
        counts[: hi - lo] = part.counts[lo:hi]
        row_tot = counts.sum(axis=1)
        # One permutation per ROW BLOCK (not per column block): the output
        # row order must be consistent across the column blocks that
        # accumulate into it.  The hash input is the row's total nnz in the
        # block row — the same quantity Algorithm 2 accumulates.
        with obs.span("admit.hash", row_block=bi, method=method):
            if method == "hash":
                params = sample_params(row_tot, table_size=R)
                perm = REORDER_METHODS["hash"](row_tot, params)
            else:
                perm = reorder(row_tot)
        perm_global[bi * R : (bi + 1) * R] = perm + lo
        nnz_hashed = counts[perm]  # [R, nbc]

        with obs.span("admit.pack_tiles", row_block=bi):
            for bj in range(nbc):
                if part.block_nnz()[bi, bj] == 0:
                    continue
                rows, cols, vals = part.block_entries(bi, bj)
                ids = part.block_entry_ids(bi, bj)
                inv = np.empty(R, dtype=np.int64)
                inv[perm] = np.arange(R)
                row_pos = inv[rows]
                order = np.lexsort((cols, row_pos))
                row_pos, cols, vals = row_pos[order], cols[order], vals[order]
                nnzb = nnz_hashed[:, bj]
                starts = np.zeros(R + 1, dtype=np.int64)
                np.cumsum(nnzb, out=starts[1:])
                k = np.arange(vals.size) - starts[row_pos]
                grp = row_pos // G
                sub = row_pos % G
                # tiles per group: ceil(group max nnz / LANE)
                gmax = np.zeros(gpb, dtype=np.int64)
                np.maximum.at(gmax, grp, nnzb[row_pos])
                ntile = -(-gmax // LANE)  # 0 for empty groups
                tile_base = np.zeros(gpb + 1, dtype=np.int64)
                np.cumsum(ntile, out=tile_base[1:])
                total = int(tile_base[-1])
                if total == 0:
                    continue
                dblk = np.zeros((total, G, LANE), dtype=np.float32)
                cblk = np.zeros((total, G, LANE), dtype=np.int32)
                t_idx = tile_base[grp] + k // LANE
                dblk[t_idx, sub, k % LANE] = vals.astype(np.float32)
                cblk[t_idx, sub, k % LANE] = cols.astype(np.int32)
                t_entries.append((ids[order], ((n_built + t_idx) * G + sub) * LANE + k % LANE))
                n_built += total
                tiles_data.append(dblk)
                tiles_cols.append(cblk)
                g_of_tile = np.repeat(np.arange(gpb), ntile)
                t_rowgroup.append(bi * gpb + g_of_tile)
                t_colblock.append(np.full(total, bj, dtype=np.int64))

    if tiles_data:
        data = np.concatenate(tiles_data)
        cols = np.concatenate(tiles_cols)
        rowgroup = np.concatenate(t_rowgroup)
        colblock = np.concatenate(t_colblock)
    else:
        data = np.zeros((0, G, LANE), dtype=np.float32)
        cols = np.zeros((0, G, LANE), dtype=np.int32)
        rowgroup = np.zeros(0, dtype=np.int64)
        colblock = np.zeros(0, dtype=np.int64)

    # Grid order: by (rowgroup, colblock) so output runs are consecutive.
    order = np.lexsort((colblock, rowgroup))
    data, cols = data[order], cols[order]
    rowgroup, colblock = rowgroup[order], colblock[order]
    first = np.ones(rowgroup.size, dtype=np.int32)
    first[1:] = (rowgroup[1:] != rowgroup[:-1]).astype(np.int32)
    # each entry's slot, its packed tile moved to that tile's grid position
    new_tile = np.empty(order.size, dtype=np.int64)
    new_tile[order] = np.arange(order.size)
    slot = np.zeros(csr.nnz, dtype=np.int64)
    per_tile = G * LANE
    for ids, flat in t_entries:
        slot[ids] = new_tile[flat // per_tile] * per_tile + flat % per_tile

    return HBPTiles(
        data=data,
        cols=cols.astype(np.int32),
        rowgroup=rowgroup.astype(np.int32),
        colblock=colblock.astype(np.int32),
        first=first,
        perm=perm_global,
        shape=csr.shape,
        cfg=cfg,
        n_rowgroups=nbr * gpb,
        slot=slot,
    )


def tuned_partition_config(
    csr: CSRMatrix,
    *,
    row_block: int = 512,
    col_block: int = 4096,
    quantile: float = 0.75,
    tile_elems: int = 1024,
) -> PartitionConfig:
    """Beyond-paper: pick the tile geometry from the matrix's nnz profile.

    The paper's warp is fixed at 32 threads; our default tile is 8 rows ×
    128 lanes.  For ultra-sparse matrices (circuit/power-law rows with
    ~4-8 nnz) a 128-wide tile is ≥94% padding — the format's HBM traffic,
    the controlling quantity of a bandwidth-bound SpMV, balloons ~30×.

    Since the nonlinear hash groups rows of similar nnz anyway, narrow
    tiles lose nothing on long rows (they simply span several consecutive
    tiles, still streamed contiguously).  We choose::

        lane  = clip(next_pow2(quantile_0.75 of per-(row, col-block) nnz), 8, 128)
        group = tile_elems // lane      (tile stays 8x128-sized in VMEM)

    Narrow lanes trade VPU lane padding (compute, which SpMV has to spare)
    for HBM bytes (which it does not).  EXPERIMENTS.md §Perf quantifies
    the utilization/traffic win per suite matrix.
    """
    from .partition import count_block_nnz

    probe = PartitionConfig(row_block=row_block, col_block=col_block)
    counts = count_block_nnz(csr, probe)
    nz = counts[counts > 0]
    q = float(np.quantile(nz, quantile)) if nz.size else 1.0
    lane = 8
    while lane < 128 and lane < q:
        lane *= 2
    # group stays 8: wider groups would mix hash buckets and pad every row
    # to a more heterogeneous group max — measured to cancel the gain.
    return PartitionConfig(
        row_block=row_block, col_block=col_block, group=8, lane=lane
    )


def tiles_from_arrays(d: dict) -> HBPTiles:
    """Rebuild :class:`HBPTiles` from plain numpy arrays and ints.

    ``d`` holds the tile fields ``data``, ``cols``, ``rowgroup``,
    ``colblock``, ``first``, ``perm``, ``shape`` and ``n_rowgroups``, plus
    the partition config either as ``cfg`` (a mapping or any object with
    ``row_block``/``col_block``/``group``/``lane`` attributes) or as those
    four keys at top level.  This is how tile state built elsewhere — for
    instance by the JAX package, whose ``HBPTiles`` has the same fields —
    is handed to this package without importing it: both then run on
    exactly the same tiles.
    """
    cfg_src = d.get("cfg", d)
    fields = ("row_block", "col_block", "group", "lane")
    if isinstance(cfg_src, dict):
        cfg = PartitionConfig(**{f: int(cfg_src[f]) for f in fields})
    else:
        cfg = PartitionConfig(**{f: int(getattr(cfg_src, f)) for f in fields})
    data = np.ascontiguousarray(d["data"], dtype=np.float32)
    cols = np.ascontiguousarray(d["cols"], dtype=np.int32)
    if data.ndim != 3 or data.shape != cols.shape:
        raise ValueError(
            f"data {data.shape} and cols {cols.shape} must both be [T, group, lane]"
        )
    if data.shape[1:] != (cfg.group, cfg.lane):
        raise ValueError(
            f"tile shape {data.shape[1:]} does not match the config's "
            f"(group, lane) = {(cfg.group, cfg.lane)}"
        )
    n_rows, n_cols = (int(v) for v in d["shape"])
    return HBPTiles(
        data=data,
        cols=cols,
        rowgroup=np.ascontiguousarray(d["rowgroup"], dtype=np.int32),
        colblock=np.ascontiguousarray(d["colblock"], dtype=np.int32),
        first=np.ascontiguousarray(d["first"], dtype=np.int32),
        perm=np.ascontiguousarray(d["perm"], dtype=np.int64),
        shape=(n_rows, n_cols),
        cfg=cfg,
        n_rowgroups=int(d["n_rowgroups"]),
    )
