"""Public HBP SpMV/SpMM entry points on PyTorch tensors.

``hbp_spmv`` / ``hbp_spmm`` stage the host-side tile format to the device
once (:func:`device_tiles`), launch the requested strategy and undo the
hash permutation:

* ``"fused"`` — the hand-written fused-combine CUDA kernels of
  :mod:`.hbp_spmv` on a CUDA device (their plain PyTorch versions on the
  CPU);
* ``"partials"`` — the paper's two-phase split: the hand-written partials
  kernels of :mod:`.hbp_spmv` write one partial block per tile, then a
  deterministic segment sum over each row group's run combines them (the
  max: a combine kernel in the same launch call as the partials);
* ``"stable"`` — the ordered lane chain of :mod:`.ref`, whose results are
  bitwise invariant to batch width and bucket padding on every device;
* ``"reference"`` — the einsum oracle of :mod:`.ref`.

``hbp_spmm(..., combine="max")`` runs the max monoid of GNN max
aggregation on every strategy (the fused or partials max kernels, or the
masked lane max of :mod:`.ref` under ``"stable"``/``"reference"``), and
``hbp_spmm_argmax`` the same max with its winners (the forward of max
aggregation's gradient, torch code as in the JAX package).

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card present they raise rather than fall back.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.tile import HBPTiles

from . import hbp_spmv as _k
from . import ref as _ref

__all__ = [
    "DeviceTiles",
    "device_tiles",
    "chunk_index",
    "resolve_device",
    "hbp_spmv",
    "hbp_spmm",
    "hbp_spmm_argmax",
    "hbp_spmm_bucketed",
    "bucket_k",
    "K_BUCKETS",
    "K_CHUNK",
    "K_TILINGS",
    "RUN_CHUNK",
    "STRATEGIES",
    "COMBINES",
    "check_strategy",
    "blocked_vector",
    "blocked_matrix",
    "stream_passes",
    "modeled_launch_bytes",
]

# RHS-width buckets of the k-padded SpMM entry: the serving engine pads a
# coalesced block to the next bucket so launch widths come from a small
# set; beyond the top bucket widths round up to multiples of it.
K_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# Width of one launch under the legacy ``k_tiling="loop"`` contract.
K_CHUNK = 128

# Launch contracts for wide k: "grid" is one launch for any k (the CUDA
# kernel flattens (run, group, column) over its threads), "loop" a host
# loop of K_CHUNK-wide launches.  Both names are kept so plans and cache
# entries written under either stay valid; the two give the same bits.
K_TILINGS = ("grid", "loop")

# Most tiles one thread of the fused kernels walks: device_tiles cuts
# every row group's run into chunks of at most this many tiles, and runs
# of more than one chunk are folded after the chunk chains (csrc/hbp_spmv.cu).
# Chosen on the card from 8, 16, 32 and 64 on m4_kron16 (PERF.md).
RUN_CHUNK = 32

STRATEGIES = ("fused", "partials", "stable", "reference")

COMBINES = ("sum", "max")

@dataclasses.dataclass(frozen=True, eq=False)
class DeviceTiles:
    """Device-resident HBP tile format.

    The tile arrays of :class:`~repro_torch.core.tile.HBPTiles` plus the
    run index: tiles are sorted by (row group, column block), so each
    non-empty row group owns one contiguous run
    ``[run_start[r], run_start[r + 1])``.  Row groups with no tiles have
    no run and come out 0 (the caller's zero-filled output), which takes
    the place of the JAX package's ``visited`` mask.

    The chunk index the fused kernels walk cuts each run into
    consecutive chunks of at most :data:`RUN_CHUNK` tiles, chunk ``i``
    being tiles ``[chunk_start[i], chunk_start[i + 1])`` and run ``r``
    chunks ``[run_chunk[r], run_chunk[r + 1])``.  A chunk of a one-chunk
    run writes its row group (``chunk_dest >= 0``); a chunk of a split
    run writes row ``~chunk_dest`` of the chunk buffer, whose rows follow
    chunk order, and ``split_run`` lists the split runs to fold.  The
    boundaries depend on the tiles alone, never on the RHS width.
    """

    rowgroup: torch.Tensor  # i32[T]
    colblock: torch.Tensor  # i32[T]
    data: torch.Tensor  # f32[T, group, lane]
    cols: torch.Tensor  # i32[T, group, lane]
    perm: torch.Tensor  # i64[padded_rows]
    run_start: torch.Tensor  # i32[n_runs + 1]
    run_rowgroup: torch.Tensor  # i32[n_runs], strictly increasing
    rg_lengths: torch.Tensor  # i64[n_rowgroups]: tiles per row group
    chunk_start: torch.Tensor  # i32[n_chunks + 1]
    run_chunk: torch.Tensor  # i32[n_runs + 1]
    chunk_dest: torch.Tensor  # i32[n_chunks]: row group, or ~(chunk buffer row)
    split_run: torch.Tensor  # i32[n_split]: runs of more than one chunk
    n_split_chunks: int  # rows of the chunk buffer
    n_rowgroups: int
    shape: Tuple[int, int]
    col_block: int

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n_tiles(self) -> int:
        return int(self.data.shape[0])

    def tensors(self):
        return tuple(
            getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        )

    @property
    def nbytes(self) -> int:
        """Device bytes the staged tensors occupy."""
        return int(sum(t.nbytes for t in self.tensors()))

    @property
    def chunk_index_nbytes(self) -> int:
        """Bytes of the chunk index the fused kernels read."""
        return int(sum(t.nbytes for t in (
            self.chunk_start, self.run_chunk, self.chunk_dest, self.split_run)))

    def chunk_buffer_nbytes(self, k: int) -> int:
        """Bytes of the split runs' chunk partials at RHS width ``k``."""
        return self.n_split_chunks * int(self.data.shape[1]) * k * 4


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def chunk_index(run_start: np.ndarray, run_rowgroup: np.ndarray, limit: int):
    """The chunk index of runs ``run_start`` (see :class:`DeviceTiles`).

    A run of ``L`` tiles becomes ``ceil(L / limit)`` chunks of near-equal
    length (``limit`` at most), in stream order.  Returns ``chunk_start``,
    ``run_chunk``, ``chunk_dest`` and ``split_run`` as int64 arrays.
    """
    lengths = np.diff(run_start)
    per_run = -(-lengths // limit)
    run_chunk = np.zeros(lengths.size + 1, np.int64)
    np.cumsum(per_run, out=run_chunk[1:])
    run_of = np.repeat(np.arange(lengths.size), per_run)
    j = np.arange(run_chunk[-1]) - run_chunk[run_of]  # position in its run
    starts = run_start[run_of] + j * lengths[run_of] // per_run[run_of]
    chunk_start = np.append(starts, run_start[-1])
    split = (per_run > 1)[run_of]
    chunk_dest = np.where(split, ~(np.cumsum(split) - 1), run_rowgroup[run_of])
    return chunk_start, run_chunk, chunk_dest, np.flatnonzero(per_run > 1)


def device_tiles(tiles: HBPTiles, device=None) -> DeviceTiles:
    """Stage ``tiles`` on ``device`` (default: the card) with the run index.

    Checks on the host, once, what the kernels rely on: each row group's
    tiles form one run (row groups strictly increase from run to run), and
    every slot's x row ``colblock * col_block + col`` lies inside the
    matrix's columns.  Builds the chunk index at :data:`RUN_CHUNK`.
    """
    dev = resolve_device(device)
    T = tiles.n_tiles
    rowgroup = np.asarray(tiles.rowgroup, np.int64)
    colblock = np.asarray(tiles.colblock, np.int64)
    first = np.asarray(tiles.first, np.int64)
    if T and not first[0]:
        raise ValueError("the first tile must start a run (first[0] == 1)")
    starts = np.flatnonzero(first)
    run_rowgroup = rowgroup[starts]
    if np.any(np.diff(run_rowgroup) <= 0):
        raise ValueError(
            "tiles are not sorted into one run per row group: run row groups "
            "must be strictly increasing"
        )
    if T and np.any(rowgroup != np.repeat(run_rowgroup, np.diff(np.append(starts, T)))):
        raise ValueError("a run mixes row groups: 'first' does not match 'rowgroup'")
    if T:
        if rowgroup.min() < 0 or rowgroup.max() >= tiles.n_rowgroups:
            raise ValueError("rowgroup ids out of range")
        cols = np.asarray(tiles.cols)
        x_row = colblock[:, None, None] * tiles.cfg.col_block + cols
        if cols.min() < 0 or x_row.max() >= tiles.shape[1]:
            raise ValueError("a tile slot reads past the matrix's columns")
    run_start = np.append(starts, T)
    lengths = np.bincount(rowgroup, minlength=tiles.n_rowgroups)
    chunk_start, run_chunk, chunk_dest, split_run = chunk_index(
        run_start, run_rowgroup, RUN_CHUNK)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    return DeviceTiles(
        rowgroup=put(rowgroup, torch.int32),
        colblock=put(colblock, torch.int32),
        data=put(tiles.data, torch.float32),
        cols=put(tiles.cols, torch.int32),
        perm=put(tiles.perm, torch.int64),
        run_start=put(run_start, torch.int32),
        run_rowgroup=put(run_rowgroup, torch.int32),
        rg_lengths=put(lengths, torch.int64),
        chunk_start=put(chunk_start, torch.int32),
        run_chunk=put(run_chunk, torch.int32),
        chunk_dest=put(chunk_dest, torch.int32),
        split_run=put(split_run, torch.int32),
        n_split_chunks=int(np.count_nonzero(chunk_dest < 0)),
        n_rowgroups=int(tiles.n_rowgroups),
        shape=(int(tiles.shape[0]), int(tiles.shape[1])),
        col_block=int(tiles.cfg.col_block),
    )


def blocked_vector(x: torch.Tensor, col_block: int) -> torch.Tensor:
    """Pad x to a multiple of ``col_block`` and reshape into segments."""
    n = x.shape[0]
    n_blocks = -(-n // col_block)
    return F.pad(x, (0, n_blocks * col_block - n)).reshape(n_blocks, col_block)


def blocked_matrix(x: torch.Tensor, col_block: int) -> torch.Tensor:
    """Pad an ``[n, k]`` RHS block to a multiple of ``col_block`` rows and
    reshape into ``[n_blocks, col_block, k]`` segments."""
    n, k = x.shape
    n_blocks = -(-n // col_block)
    return F.pad(x, (0, 0, 0, n_blocks * col_block - n)).reshape(n_blocks, col_block, k)


def stream_passes(k: int, strategy: str, k_tiling: str) -> int:
    """How many times one call walks the packed tile stream.

    Every strategy reads the stream once for any k under ``"grid"`` (the
    CUDA kernel serves all k columns in one launch; the torch paths chain
    over the full width); ``"loop"`` reads it once per ``K_CHUNK``-wide
    launch.
    """
    if k_tiling == "loop":
        return max(1, -(-k // K_CHUNK))
    return 1


def modeled_launch_bytes(dt: DeviceTiles, k: int, strategy: str, k_tiling: str) -> int:
    """Modeled device-memory bytes one SpMM call moves (the bandwidth ledger).

    The tile stream (data f32 + cols i32 + the per-tile column block and
    the run index) is paid once per stream pass; each stored slot gathers
    one f32 of x per RHS column; the output block is written once.  Under
    ``"partials"`` the per-tile partials buffer (``T * group * k`` f32) is
    written by the kernel and read back by the combine.  The fused
    kernels (sum and max alike) read the chunk index once per pass, and
    write the chunk buffer of the split runs (``n_split_chunks * group *
    k`` f32) and read it back once.  A model, not a measurement: it
    assumes no cache reuse of the gathers.
    """
    passes = stream_passes(k, strategy, k_tiling)
    stream = dt.data.nbytes + dt.cols.nbytes + dt.colblock.nbytes
    stream += dt.run_start.nbytes + dt.run_rowgroup.nbytes
    k = max(k, 1)
    gathers = dt.data.numel() * k * 4
    group = dt.data.shape[1]
    out = dt.n_rowgroups * group * k * 4
    extra = 0
    if strategy == "partials":
        extra = 2 * dt.n_tiles * group * k * 4
    elif strategy == "fused":
        extra = passes * dt.chunk_index_nbytes + 2 * dt.chunk_buffer_nbytes(k)
    return int(passes * stream + gathers + out + extra)


def _record_launch(
    dt: DeviceTiles, k: int, *, op: str, strategy: str, k_tiling: str, combine: str = "sum",
    passes: Optional[int] = None,
) -> None:
    """Gated kernel-traffic accounting: one bump per entry-point call.
    ``passes`` overrides the tile-stream passes of the call (the argmax's
    one or three)."""
    if not obs.enabled():
        return
    obs.counter(
        "kernels.launches", op=op, strategy=strategy, k_tiling=k_tiling, combine=combine
    ).inc()
    n_passes = stream_passes(k, strategy, k_tiling) if passes is None else passes
    obs.counter("kernels.traversals").inc(n_passes)
    obs.counter("kernels.bytes_modeled").inc(
        modeled_launch_bytes(dt, k, strategy, k_tiling))
    obs.counter("kernels.k_tiling", choice=k_tiling).inc()
    obs.histogram("kernels.launch_k").observe(k)


def check_strategy(strategy: str, k_tiling: str = "grid") -> None:
    """Raise for a strategy or contract this package does not serve."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (expected one of {STRATEGIES})")
    if k_tiling not in K_TILINGS:
        raise ValueError(f"unknown k_tiling {k_tiling!r} (expected one of {K_TILINGS})")


def _resolve(tiles, x, device, n_rowgroups, n_rows, col_block) -> Tuple[DeviceTiles, torch.Tensor]:
    """Staged tiles and x as f32 on their device; checks the metadata."""
    if isinstance(tiles, HBPTiles):
        dt = device_tiles(tiles, device)
    elif isinstance(tiles, DeviceTiles):
        dt = tiles
        want = resolve_device(device) if device is not None else dt.device
        # "cuda" (no index) names whichever card the tiles are on
        if want.type != dt.device.type or want.index not in (None, dt.device.index):
            raise ValueError(f"tiles are staged on {dt.device}, not {device}")
    else:
        raise TypeError(f"expected HBPTiles or DeviceTiles, got {type(tiles).__name__}")
    for name, given, staged in (
        ("n_rowgroups", n_rowgroups, dt.n_rowgroups),
        ("n_rows", n_rows, dt.shape[0]),
        ("col_block", col_block, dt.col_block),
    ):
        if given is not None and given != staged:
            raise ValueError(f"{name}={given} does not match the staged tiles ({staged})")
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device != dt.device:
        if x.device.type == "cpu" and dt.device.type == "cuda":
            # pinned staging lets the copy queue behind in-flight launches
            # instead of blocking the host on them
            x = x.pin_memory().to(dt.device, non_blocking=True)
        else:
            x = x.to(dt.device)
    if x.shape[0] != dt.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows but the matrix has {dt.shape[1]} columns")
    return dt, x


def hbp_spmv(
    tiles: HBPTiles | DeviceTiles,
    x,
    *,
    strategy: Literal["fused", "partials", "stable", "reference"] = "fused",
    n_rowgroups: Optional[int] = None,
    n_rows: Optional[int] = None,
    col_block: Optional[int] = None,
    k_tiling: Literal["grid", "loop"] = "grid",
    device=None,
) -> torch.Tensor:
    """HBP SpMV: ``y = A @ x`` with A in HBP tile format, ``f32[n_rows]``.

    ``k_tiling`` is accepted so a serving plan can pass one keyword set to
    both entry points; a single vector is one launch under either.
    ``device`` applies when ``tiles`` are host tiles still to be staged.
    """
    check_strategy(strategy, k_tiling)
    dt, x = _resolve(tiles, x, device, n_rowgroups, n_rows, col_block)
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    _record_launch(dt, 1, op="spmv", strategy=strategy, k_tiling=k_tiling)
    if dt.n_tiles == 0:  # empty matrix: no tiles, y == 0
        return torch.zeros(dt.shape[0], dtype=torch.float32, device=dt.device)
    if strategy == "fused":
        y_hashed = _k.hbp_spmv_fused(dt, x)
    elif strategy == "partials":
        # the k = 1 case of the partials SpMM: the same partials and the
        # same run combine, so a vector served alone gets the bits of its
        # column in any batched launch
        y_hashed = _ref.segment_sum_sorted(
            _k.hbp_spmv_partials(dt, x)[..., None], dt.rowgroup, dt.n_rowgroups,
            dt.rg_lengths,
        )[..., 0]
    elif strategy == "reference":
        y_hashed = _ref.hbp_spmv_hashed_ref(
            dt.rowgroup, dt.colblock, dt.data, dt.cols, blocked_vector(x, dt.col_block),
            n_rowgroups=dt.n_rowgroups, lengths=dt.rg_lengths,
        )
    else:  # "stable": the k = 1 column of the batch-width-invariant SpMM
        y_hashed = _ref.hbp_spmm_hashed_stable(
            dt.rowgroup, dt.colblock, dt.data, dt.cols,
            blocked_matrix(x[:, None], dt.col_block),
            n_rowgroups=dt.n_rowgroups, lengths=dt.rg_lengths,
        )[..., 0]
    return _ref.unpermute(y_hashed, dt.perm, dt.shape[0])


def _spmm_hashed(dt: DeviceTiles, x: torch.Tensor, strategy: str, combine: str) -> torch.Tensor:
    """One SpMM call on ``strategy``, hashed row order ``[n_rg, group, k]``.

    Under ``combine="max"`` rows with no live entry, and row groups with
    no tiles, carry the monoid's identity ``-inf``; the caller maps it to
    0 once, after assembly."""
    if combine == "max":
        if strategy == "fused":
            return _k.hbp_spmm_fused_max(dt, x)
        if strategy == "partials":
            # kernel 4 and its run combine in one launch call
            return _k.hbp_spmm_partials_max(dt, x, runs=True)
        # max is exact in any order: the masked lane max is "stable" and
        # "reference" at once
        return _ref.hbp_spmm_hashed_max(
            dt.rowgroup, dt.colblock, dt.data, dt.cols, blocked_matrix(x, dt.col_block),
            n_rowgroups=dt.n_rowgroups, lengths=dt.rg_lengths,
        )
    if strategy == "fused":
        return _k.hbp_spmm_fused(dt, x)
    if strategy == "partials":
        return _ref.segment_sum_sorted(
            _k.hbp_spmm_partials(dt, x), dt.rowgroup, dt.n_rowgroups, dt.rg_lengths
        )
    fn = _ref.hbp_spmm_hashed_stable if strategy == "stable" else _ref.hbp_spmm_hashed_ref
    return fn(
        dt.rowgroup, dt.colblock, dt.data, dt.cols, blocked_matrix(x, dt.col_block),
        n_rowgroups=dt.n_rowgroups, lengths=dt.rg_lengths,
    )


def hbp_spmm(
    tiles: HBPTiles | DeviceTiles,
    x,  # [n_cols, k]
    *,
    strategy: Literal["fused", "partials", "stable", "reference"] = "fused",
    combine: Literal["sum", "max"] = "sum",
    n_rowgroups: Optional[int] = None,
    n_rows: Optional[int] = None,
    col_block: Optional[int] = None,
    k_tiling: Literal["grid", "loop"] = "grid",
    device=None,
) -> torch.Tensor:
    """HBP multi-RHS SpMM: ``Y = A @ X`` with ``X: [n_cols, k]``, ``f32[n_rows, k]``.

    ``k_tiling="grid"`` serves any k in one call; ``"loop"`` is a host
    loop of ``K_CHUNK``-wide calls.  Each output column is computed
    independently of the others, so both give the same result.

    ``combine`` selects the reduction monoid: ``"sum"`` is the standard
    SpMM; ``"max"`` computes ``Y[i, c] = max_j A[i, j] * X[j, c]`` over
    A's stored nonzero entries, 0 for rows with none (GNN max
    aggregation).
    """
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r} (expected one of {COMBINES})")
    check_strategy(strategy, k_tiling)
    dt, x = _resolve(tiles, x, device, n_rowgroups, n_rows, col_block)
    if x.dim() != 2:
        raise ValueError(f"X must be [n_cols, k], got shape {tuple(x.shape)}")
    k = x.shape[1]
    _record_launch(dt, k, op="spmm", strategy=strategy, k_tiling=k_tiling, combine=combine)
    if dt.n_tiles == 0:  # empty matrix: Y == 0
        return torch.zeros((dt.shape[0], k), dtype=torch.float32, device=dt.device)
    x = x.contiguous()
    if k_tiling == "grid" or k <= K_CHUNK:
        y_hashed = _spmm_hashed(dt, x, strategy, combine)
    else:
        y_hashed = torch.cat(
            [
                _spmm_hashed(dt, x[:, lo : lo + K_CHUNK].contiguous(), strategy, combine)
                for lo in range(0, k, K_CHUNK)
            ],
            dim=-1,
        )
    if combine == "max":
        # rows with no live entry hold the identity; they aggregate to 0
        # (the convention for isolated graph nodes)
        y_hashed = y_hashed.masked_fill_(torch.isneginf(y_hashed), 0.0)
    return _ref.unpermute(y_hashed, dt.perm, dt.shape[0])


def bucket_k(k: int, buckets: tuple = K_BUCKETS) -> int:
    """Smallest bucket width >= k; beyond the top bucket, the next
    *multiple* of it (a request is never clamped down)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not buckets:
        raise ValueError("buckets must be non-empty")
    for b in buckets:
        if k <= b:
            return int(b)
    top = buckets[-1]
    return -(-k // top) * top


def hbp_spmm_bucketed(
    tiles: HBPTiles | DeviceTiles,
    x,  # [n_cols, k]
    *,
    buckets: tuple = K_BUCKETS,
    **kwargs,
) -> torch.Tensor:
    """k-padded SpMM: pad the RHS block with zero columns to the next
    bucket width, launch :func:`hbp_spmm`, slice the real columns back out.

    Under ``"fused"``, ``"partials"`` and ``"stable"`` the surviving
    columns are bitwise identical to the unpadded call, and under
    ``combine="max"`` on every strategy: each column is computed on its
    own.  This is the entry the serving micro-batcher routes coalesced
    blocks through.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    k = x.shape[1]
    kb = bucket_k(k, buckets)
    if kb != k:
        x = F.pad(x, (0, kb - k))
    return hbp_spmm(tiles, x, **kwargs)[:, :k]


def hbp_spmm_argmax(
    tiles: HBPTiles | DeviceTiles,
    x,  # [n_cols, k]
    *,
    n_rowgroups: Optional[int] = None,
    n_rows: Optional[int] = None,
    col_block: Optional[int] = None,
    passes: Literal[1, 3] = 1,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Max-monoid SpMM with winner tracking: ``(y, idx, coeff)``, each
    ``[n_rows, k]``.

    ``y`` is ``hbp_spmm(..., combine="max")``'s result, bit for bit;
    ``idx[i, c]`` (int32) is the global source column whose stored entry
    attained the max (ties to the lowest column, ``-1`` for rows with no
    live entry) and ``coeff[i, c]`` that entry's value (0 where ``idx`` is
    -1).  The forward of differentiable max aggregation
    (:mod:`.autodiff`): the backward scatters ``coeff * cotangent`` to row
    ``idx`` of the input.

    As in the JAX package this is not a TPU kernel: the reduction is the
    monoid-exact lane chain of :mod:`.ref` in torch code, on the device
    the tiles are staged on.  ``passes=1`` (default) carries a paired
    (value, index, coefficient) payload through one pass over the tile
    stream (:func:`.ref.hbp_spmm_hashed_argmax_onepass`); ``passes=3`` is
    the three-pass oracle (:func:`.ref.hbp_spmm_hashed_argmax`).  Both
    give the same triple.
    """
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes!r}")
    dt, x = _resolve(tiles, x, device, n_rowgroups, n_rows, col_block)
    if x.dim() != 2:
        raise ValueError(f"X must be [n_cols, k], got shape {tuple(x.shape)}")
    k = x.shape[1]
    _record_launch(dt, k, op="spmm_argmax", strategy="stable", k_tiling="grid",
                   combine="max", passes=passes)
    n = dt.shape[0]
    if dt.n_tiles == 0:  # no tiles: every row is empty
        return (torch.zeros((n, k), dtype=torch.float32, device=dt.device),
                torch.full((n, k), -1, dtype=torch.int32, device=dt.device),
                torch.zeros((n, k), dtype=torch.float32, device=dt.device))
    fn = _ref.hbp_spmm_hashed_argmax_onepass if passes == 1 else _ref.hbp_spmm_hashed_argmax
    y_h, idx_h, coeff_h = fn(
        dt.rowgroup, dt.colblock, dt.data, dt.cols, blocked_matrix(x.contiguous(), dt.col_block),
        n_rowgroups=dt.n_rowgroups, lengths=dt.rg_lengths,
    )
    y_h = y_h.masked_fill_(torch.isneginf(y_h), 0.0)  # empty rows aggregate to 0
    return (_ref.unpermute(y_h, dt.perm, n), _ref.unpermute(idx_h, dt.perm, n),
            _ref.unpermute(coeff_h, dt.perm, n))
