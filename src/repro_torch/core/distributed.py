"""Distributed SpMV: the paper's block scheduling across ranks.

The tile stream is split over the ranks of a ``torch.distributed`` process
group (SPMD: one process per rank, each calling the same functions), and
the combine part becomes one collective.  Two placements mirror the
paper's fixed/competitive split, tile for tile as the JAX package places
them:

* ``grid``     — locality first (the *fixed* part writ large): tile ``t``
  goes to rank ``colblock[t] % world``, so a rank's tiles share the x
  segments of its column blocks;
* ``balanced`` — the *competitive* part: tiles are LPT-assigned to ranks
  by count regardless of position (:func:`~repro_torch.core.schedule.lpt_schedule`
  over unit costs, the deterministic replay of the paper's ticket lock).
  Better makespan on power-law matrices.

Each rank's list is padded with null tiles (row group -1, zero data) to
the longest list's length ``t_max``, the equal per-rank quota of the
JAX package's SPMD shards; ``loads`` counts each rank's real tiles.

The local body is the JAX package's gather, lane sum and segment sum with
a scratch row: kernel 5 (``hbp_spmv_partials``, each tile's lane sums
``[T, group]``) on the card, its plain version on the CPU, then the sum
over each row group's tiles, where null tiles land in a scratch row that
is dropped.  The shard is sorted by row group (stably, null tiles last)
when it is built, so that sum is :func:`ref.segment_sum_sorted`'s, in a
fixed order: two calls with the same x give the same bits.  The combine
is one ``all_reduce`` (SUM) under both placements, as the JAX package
combines both with one ``psum``; every rank then holds the whole ``y``
and undoes the hash permutation itself.

The process group is the caller's (``torch.distributed.init_process_group``
with an explicit address, world size and rank).  NCCL needs one card per
rank; gloo reduces CPU tensors, and CUDA ones through the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Literal, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

from .formats import CSRMatrix
from .partition import PartitionConfig
from .schedule import lpt_schedule
from .tile import HBPTiles, build_tiles

__all__ = [
    "MODES",
    "ShardedSpmv",
    "build_sharded_spmv",
    "shard_tiles",
    "place_tiles",
    "pad_shard",
]

MODES = ("balanced", "grid")


def place_tiles(tiles: HBPTiles, world: int, mode: str) -> Tuple[List[np.ndarray], np.ndarray]:
    """Each rank's tile ids, in execution order, and ``loads`` (real tiles
    per rank, float64) under placement ``mode``."""
    if mode == "balanced":
        assign = lpt_schedule(np.ones(tiles.n_tiles), world).assignment
    elif mode == "grid":
        assign = [[] for _ in range(world)]
        for t in range(tiles.n_tiles):
            assign[int(tiles.colblock[t]) % world].append(t)
    else:
        raise ValueError(f"unknown placement {mode!r} (expected one of {MODES})")
    ids = [np.asarray(a, dtype=np.int64) for a in assign]
    return ids, np.array([a.size for a in ids], dtype=np.float64)


def pad_shard(tiles: HBPTiles, ids: np.ndarray, t_max: int):
    """``(data, cols, rowgroup, colblock)`` of tiles ``ids`` padded with
    null tiles (row group -1, zero data, column 0 of block 0) to ``t_max``."""
    n_pad = t_max - ids.size
    G, L = tiles.data.shape[1:]
    return (
        np.concatenate([tiles.data[ids], np.zeros((n_pad, G, L), tiles.data.dtype)]),
        np.concatenate([tiles.cols[ids], np.zeros((n_pad, G, L), tiles.cols.dtype)]),
        np.concatenate([tiles.rowgroup[ids], np.full(n_pad, -1, tiles.rowgroup.dtype)]),
        np.concatenate([tiles.colblock[ids], np.zeros(n_pad, tiles.colblock.dtype)]),
    )


@dataclasses.dataclass
class ShardedSpmv:
    """This rank's tile shard on its device and the sharded matvec."""

    mode: str
    tiles: HBPTiles  # the whole tile stream (host)
    rank: int
    world: int
    group: Optional[dist.ProcessGroup]
    ids: np.ndarray  # this rank's tile ids, in placement order
    t_max: int  # the padded per-rank length
    loads: np.ndarray  # real tiles per rank
    # the padded shard sorted by row group, null tiles as the scratch row
    # group ``n_rowgroups``
    local: ops.DeviceTiles
    n_rows: int

    @property
    def device(self) -> torch.device:
        return self.local.device

    def matvec(self, x) -> torch.Tensor:
        """``y = A @ x`` in the original row order, on every rank."""
        from repro_torch.kernels.hbp_spmv import hbp_spmv_partials

        n_cols = self.tiles.shape[1]
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.shape != (n_cols,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected ({n_cols},)")
        nrg = self.tiles.n_rowgroups
        contrib = hbp_spmv_partials(self.local, x)  # [t_max, group]
        y = _ref.segment_sum_sorted(
            contrib, self.local.rowgroup, nrg + 1, self.local.rg_lengths
        )[:nrg]  # drop the null tiles' scratch row
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return _ref.unpermute(y, self.local.perm, self.n_rows)


def shard_tiles(
    tiles: HBPTiles,
    *,
    mode: Literal["grid", "balanced"] = "balanced",
    group: Optional[dist.ProcessGroup] = None,
    device=None,
) -> ShardedSpmv:
    """Place ``tiles`` over the ranks of ``group`` (default: the world) and
    stage this rank's shard on ``device`` (default: the card; raises
    without one)."""
    dev = ops.resolve_device(device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    ids_all, loads = place_tiles(tiles, world, mode)
    t_max = max((a.size for a in ids_all), default=1)
    ids = ids_all[rank]
    data, cols, rowgroup, colblock = pad_shard(tiles, ids, t_max)
    nrg = tiles.n_rowgroups
    seg = np.where(rowgroup < 0, nrg, rowgroup)
    order = np.argsort(seg, kind="stable")
    seg = seg[order]
    first = np.ones(seg.size, np.int32)
    first[1:] = seg[1:] != seg[:-1]
    shard = HBPTiles(
        data=data[order],
        cols=cols[order],
        rowgroup=seg.astype(np.int32),
        colblock=colblock[order],
        first=first,
        perm=tiles.perm,
        shape=tiles.shape,
        cfg=tiles.cfg,
        n_rowgroups=nrg + 1,
    )
    return ShardedSpmv(
        mode=mode,
        tiles=tiles,
        rank=rank,
        world=world,
        group=group,
        ids=ids,
        t_max=int(t_max),
        loads=loads,
        local=ops.device_tiles(shard, dev),
        n_rows=int(tiles.shape[0]),
    )


def build_sharded_spmv(
    csr: CSRMatrix,
    *,
    cfg: Optional[PartitionConfig] = None,
    mode: Literal["grid", "balanced"] = "balanced",
    group: Optional[dist.ProcessGroup] = None,
    device=None,
) -> ShardedSpmv:
    """Build ``csr``'s hashed tiles (every rank builds the same ones) and
    keep this rank's shard under placement ``mode``."""
    cfg = cfg or PartitionConfig()
    return shard_tiles(build_tiles(csr, cfg, method="hash"), mode=mode, group=group,
                       device=device)
