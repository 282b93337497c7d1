"""HBP SpMV/SpMM: the Hopper kernels and their plain versions.

Each wrapper takes staged tiles (:class:`~repro_torch.kernels.ops.DeviceTiles`)
and an unpadded right-hand side.  The fused-combine kernels
(``csrc/hbp_spmv.cu``) return the product in hashed row order:

* :func:`hbp_spmv_fused` — ``x: f32[n_cols]`` -> ``f32[n_rowgroups, group]``
  (replaces ``_fused_kernel`` / ``hbp_spmv_fused`` in
  ``src/repro/kernels/hbp_spmv.py``);
* :func:`hbp_spmm_fused` — ``x: f32[n_cols, k]`` ->
  ``f32[n_rowgroups, group, k]``, any k in one launch (replaces
  ``_fused_spmm_kernel`` / ``hbp_spmm_fused``);
* :func:`hbp_spmm_fused_max` — the same under the max monoid, ``-inf``
  where a row has no live entry (replaces ``_fused_spmm_max_kernel`` /
  ``hbp_spmm_fused_max``).

:func:`hbp_spmm_fused_argmax` (``csrc/hbp_argmax.cu``) is the same max
with its winners, ``(y, idx, coeff)``: it replaces no TPU kernel (the JAX
package's argmax SpMM is jnp code) but the torch lane chain
:func:`.ref.hbp_spmm_hashed_argmax_onepass`, its plain version, on the
card.

:func:`hbp_sddmm` (``csrc/hbp_sddmm.cu``) is GAT's attention gradient,
one dot product per stored CSR entry and head; it replaces no TPU kernel
either (the JAX package has no GAT) and walks the CSR, not the tiles.

The four fused wrappers walk the chunk index of
:class:`~repro_torch.kernels.ops.DeviceTiles`: no thread chains more than
``ops.RUN_CHUNK`` tiles, and the runs cut into several chunks are folded
in chunk order by a second kernel of the same launch call, through a
chunk buffer ``[n_split_chunks, group(, k)]`` that the wrapper allocates.
The max kernels give each chunk up to a block of threads, each one row
and a float4 column quad (or one column) at group 8, in the launch
geometry of :func:`partials_geometry` over the chunks.

The two-phase kernels (``csrc/hbp_partials.cu``) return one partial block
per tile, ``[n_tiles, group(, k)]``, and leave the combine over each row
group's run of tiles to the caller (``ops``):

* :func:`hbp_spmv_partials` (replaces ``_partials_kernel`` /
  ``hbp_spmv_partials``);
* :func:`hbp_spmm_partials` (replaces ``_partials_spmm_kernel`` /
  ``hbp_spmm_partials``);
* :func:`hbp_spmm_partials_max` (replaces ``_partials_spmm_max_kernel`` /
  ``hbp_spmm_partials_max``), ``-inf`` where a tile row has no live slot;
  with ``runs=True`` the same launch call also folds each row group's run
  of partials on the card, which the entry point uses.

All three give each tile up to two warps of one block, in the launch
geometry of :func:`partials_geometry`: its vector path (16-byte column
quads) when k is a multiple of 4 and x is 16-byte aligned, its
scalar-column path otherwise.  Both give the same bits.

The max kernels carry NaN as the JAX package's ``jnp.max`` does: a live
slot whose product is NaN makes its output NaN, while a masked slot
(stored value 0) is ``-inf`` whatever x holds; their plain versions
(``torch.maximum``) agree with them exactly, NaN positions included.

On a CUDA tensor a wrapper launches its kernel (the sources' header notes
give the design and what bounds it) or raises; on a CPU tensor it runs the
plain PyTorch version beside it.  Nothing falls back from one to the
other.  Each wrapper counts its kernel launches in a plain integer
attribute, ``launches``.  No wrapper records an autograd graph: given an
x that requires grad while grad mode is on, each raises on either device
(the JAX package refuses to differentiate ``pallas_call`` too); training
goes through :mod:`repro_torch.kernels.autodiff`, whose backward is one
more launch on the transpose tiles.

Slot ``(t, g, l)`` reads x row ``colblock[t] * col_block + cols[t, g, l]``.
Tile packing only emits tiles of column blocks that hold entries, so
every such row — padded slots included, which carry column 0 — lies below
``n_cols``, and x needs no padding to whole column blocks;
``ops.device_tiles`` checks this bound once when it stages the tiles.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref as _ref

__all__ = [
    "PartialsGeometry",
    "partials_geometry",
    "hbp_spmv_fused",
    "hbp_spmm_fused",
    "hbp_spmm_fused_max",
    "hbp_spmm_fused_argmax",
    "hbp_spmv_partials",
    "hbp_spmm_partials",
    "hbp_spmm_partials_max",
    "hbp_spmv_fused_plain",
    "hbp_spmm_fused_plain",
    "hbp_spmm_fused_max_plain",
    "hbp_spmm_fused_argmax_plain",
    "hbp_spmv_partials_plain",
    "hbp_spmm_partials_plain",
    "hbp_spmm_partials_max_plain",
    "hbp_sddmm",
]


def hbp_spmm_fused_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused SpMM: the same terms in the same order.

    Each tile's lanes are chained in order (:func:`ref.lane_chain`), then
    each row group's tiles are summed in stream order over its run.  The
    kernel keeps one fused multiply-add chain across each chunk of at most
    ``RUN_CHUNK`` tiles and adds the chunks in order, so the two agree to
    rounding, not bitwise.  Every step is elementwise or a per-element run
    sum, so a column's bits do not depend on the batch width here either.
    """
    contrib = _ref.lane_chain(dt.colblock, dt.data, dt.cols, x, dt.col_block)
    return _ref.segment_sum_sorted(contrib, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths)


def hbp_spmv_fused_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused SpMV: the plain SpMM at k = 1."""
    return hbp_spmm_fused_plain(dt, x[:, None])[..., 0]


def hbp_spmm_fused_max_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused max SpMM: the masked lane max of each
    tile row (:func:`ref.lane_max`), then the max over each run.  Max is
    exact in any order, so this equals the kernel bitwise."""
    contrib = _ref.lane_max(dt.colblock, dt.data, dt.cols, x, dt.col_block)
    return _ref.segment_max_sorted(contrib, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths)


def hbp_spmm_fused_argmax_plain(dt, x: torch.Tensor):
    """Plain version of the fused argmax SpMM: the one-pass paired lane
    chain (:func:`ref.hbp_spmm_hashed_argmax_onepass`), equal to the
    kernel bitwise, NaN positions and the sign of zero included."""
    n, k = x.shape
    x_blocked = F.pad(x, (0, 0, 0, -n % dt.col_block)).reshape(-1, dt.col_block, k)
    return _ref.hbp_spmm_hashed_argmax_onepass(
        dt.rowgroup, dt.colblock, dt.data, dt.cols, x_blocked,
        n_rowgroups=dt.n_rowgroups, lengths=dt.rg_lengths,
    )


def hbp_spmm_partials_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the partials SpMM: each tile's ordered lane chain
    ``[n_tiles, group, k]`` (the kernel fuses each multiply and add, so
    the two agree to rounding)."""
    return _ref.lane_chain(dt.colblock, dt.data, dt.cols, x, dt.col_block)


def hbp_spmv_partials_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the partials SpMV: the plain partials SpMM at k = 1."""
    return hbp_spmm_partials_plain(dt, x[:, None])[..., 0]


def hbp_spmm_partials_max_plain(dt, x: torch.Tensor, *, runs: bool = False) -> torch.Tensor:
    """Plain version of the partials max SpMM: each tile row's masked lane
    max ``[n_tiles, group, k]``, equal to the kernel bitwise; with ``runs``
    also the max over each row group's run (:func:`ref.segment_max_sorted`),
    ``[n_rowgroups, group, k]``."""
    contrib = _ref.lane_max(dt.colblock, dt.data, dt.cols, x, dt.col_block)
    if runs:
        return _ref.segment_max_sorted(contrib, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths)
    return contrib


def _check(dt, x: torch.Tensor, ndim: int, name: str) -> None:
    if x.dim() != ndim or x.shape[0] != dt.shape[1]:
        want = "[n_cols]" if ndim == 1 else "[n_cols, k]"
        raise ValueError(
            f"{name}: x has shape {tuple(x.shape)}, expected {want} with "
            f"n_cols = {dt.shape[1]}"
        )
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if x.device != dt.data.device:
        raise ValueError(f"{name}: x is on {x.device}, the tiles on {dt.data.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        # the kernel writes its output with no autograd graph; the plain
        # version stands for it on the CPU and refuses the same way
        raise RuntimeError(
            f"{name}: the kernel records no autograd graph, and x requires grad; "
            "differentiate through repro_torch.graph.make_diff_aggregator or "
            "plan_diff_aggregator (repro_torch.kernels.autodiff), whose backward "
            "launches the kernels on the transpose tiles, or call under torch.no_grad()"
        )


def _launch(lib: str, fn_name: str, tensors, dt, x: torch.Tensor, counts, *tail: int) -> None:
    """Launch ``fn_name`` of library ``lib`` with the C signature's order:
    the pointers of ``tensors``, the run, chunk or tile ``counts``, the
    tile geometry, ``tail`` (``k`` for SpMM, then the tile-row kernel's
    launch geometry where it takes one), the device and the stream."""
    from .build import library

    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: every operand must be contiguous")
    if dt.data.dtype != torch.float32 or dt.cols.dtype != torch.int32:
        raise TypeError(f"{fn_name}: tiles must be f32 data and i32 cols")
    # the kernels read each tile row as 16-byte vectors
    if dt.data.data_ptr() % 16 or dt.cols.data_ptr() % 16:
        raise ValueError(f"{fn_name}: tile data and cols must be 16-byte aligned")
    _, group, lane = dt.data.shape
    err = getattr(library(lib), fn_name)(
        *(t.data_ptr() for t in tensors), *counts, group, lane, dt.col_block, *tail,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


# threads per block (kThreads of csrc/hbp_chain.cuh)
THREADS = 256
# column units a tile's threads cover in one slab of the grid
SLAB = 32
# threads a tile is given where k allows: two warps (on m4_kron16 faster
# than one, four or eight, PERF.md)
TILE_THREADS = 64
# rows a thread of the fused max takes of a chunk: one, so a chunk gets up
# to a block of threads at group 8 (m4_kron16 has 19x fewer chunks than
# tiles; there one row a thread beat two to eight at k = 8, 128 and 256,
# PERF.md)
CHUNK_ROWS = 1


@dataclasses.dataclass(frozen=True)
class PartialsGeometry:
    """Launch geometry of the tile-row kernels (``csrc/hbp_rows.cuh``,
    ``csrc/hbp_partials.cu``): the partials kernels, whose items are tiles,
    and the fused max, whose items are chunks of row-group runs.

    A thread computes ``width`` consecutive columns (one column unit) of
    ``rows`` consecutive rows of one item.  An item's ``tile_threads`` =
    ``slab * group // rows`` threads are (row block, column unit), the unit
    fastest; a block of ``block`` threads holds ``block // tile_threads``
    items; ``grid`` is (item blocks, slabs of ``slab`` column units).
    """

    width: int
    rows: int
    slab: int
    block: int
    grid: Tuple[int, int]

    @property
    def launch_args(self) -> Tuple[int, ...]:
        """The C launchers' geometry arguments, in their order."""
        return (self.width, self.rows, self.slab, self.block, *self.grid)


def _geometry(n_tiles: int, group: int, k: int, width: int, rows: int,
              slab: int) -> PartialsGeometry:
    tile_threads = slab * (group // rows)
    per_block = THREADS // tile_threads
    units = -(-k // width)
    return PartialsGeometry(width, rows, slab, per_block * tile_threads,
                            (-(-n_tiles // per_block), -(-units // slab)))


@functools.lru_cache(maxsize=1024)
def partials_geometry(n_tiles: int, group: int, k: int, aligned: bool,
                      rows: Optional[int] = None) -> PartialsGeometry:
    """The launch of a tile-row kernel over ``n_tiles`` items (tiles, or
    the fused max's chunks) of ``group`` rows at width ``k`` (1 for SpMV).

    The vector path (``width`` 4: float4 gathers and stores) needs k a
    multiple of 4 and x and the output 16-byte ``aligned``; any other k
    or x takes the scalar-column path (``width`` 1).  A thread takes
    ``rows`` of an item's rows (the fused max: ``CHUNK_ROWS``), or by
    default as many (up to 8, dividing ``group``) as leave a tile
    ``TILE_THREADS`` threads: at k = 128, 64 threads of 4 columns and 4
    rows each, two warps of one block per tile; at k <= 32 one row per
    thread.  Cached: the wrappers ask for it on every call.
    """
    width = 4 if aligned and k % 4 == 0 else 1
    slab = min(k // width, SLAB)
    if rows is None:
        rows = 8
        while rows > 1 and (group % rows or slab * group < TILE_THREADS * rows):
            rows //= 2
    slab = min(slab, THREADS * rows // group)
    if slab < 1 or group % rows:
        raise ValueError(f"tile-row kernels: group {group} does not fit a block "
                         f"at {rows} rows a thread")
    return _geometry(n_tiles, group, k, width, rows, slab)


def _default_geometry(dt, n_items: int, k: int, operands,
                      rows: Optional[int] = None) -> PartialsGeometry:
    """:func:`partials_geometry` for these operands (x and the output)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    return partials_geometry(n_items, dt.data.shape[1], k, aligned, rows)


def _fused_launch(fn_name: str, dt, x: torch.Tensor, y: torch.Tensor, *tail: int) -> None:
    """Launch the chunk chains and the fold of the split runs into ``y``
    (``tail``: ``k`` for SpMM, then the fused max's launch geometry); the
    chunk buffer is allocated here, uninitialised (every row is written by
    the chains before the fold reads it)."""
    k = tail[:1] if x.dim() == 2 else ()
    partial = torch.empty(
        (dt.n_split_chunks, dt.data.shape[1], *k), dtype=torch.float32, device=x.device
    )
    tensors = (
        dt.data, dt.cols, dt.colblock, dt.chunk_start, dt.chunk_dest, dt.run_chunk,
        dt.split_run, dt.run_rowgroup, x, partial, y,
    )
    counts = (dt.chunk_dest.shape[0], dt.split_run.shape[0])
    _launch("hbp_spmv", fn_name, tensors, dt, x, counts, *tail)


def _fused_max(dt, x: torch.Tensor, y: torch.Tensor,
               geometry: Optional[PartialsGeometry] = None) -> None:
    """Launch the fused max into ``y``: its chunk chains run the tile-row
    kernel over the chunks in ``geometry`` (default: the one
    :func:`partials_geometry` picks at ``CHUNK_ROWS`` rows a thread)."""
    k = x.shape[1]
    g = geometry or _default_geometry(dt, dt.chunk_dest.shape[0], k, (x, y), CHUNK_ROWS)
    _fused_launch("hbp_spmm_fused_max_launch", dt, x, y, k, *g.launch_args)


def _fused_argmax(dt, x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                  coeff: torch.Tensor) -> None:
    """Launch the argmax chunk chains and their fold into ``y``, ``idx`` and
    ``coeff`` in the fused max's geometry (:func:`partials_geometry` at
    ``CHUNK_ROWS`` rows a thread); the three chunk buffers are allocated
    here, uninitialised."""
    k = x.shape[1]
    buf = (dt.n_split_chunks, dt.data.shape[1], k)
    part = (torch.empty(buf, dtype=torch.float32, device=x.device),
            torch.empty(buf, dtype=torch.int32, device=x.device),
            torch.empty(buf, dtype=torch.float32, device=x.device))
    n_chunks = dt.chunk_dest.shape[0]
    g = _default_geometry(dt, n_chunks, k, (x, y, idx, coeff, *part), CHUNK_ROWS)
    tensors = (
        dt.data, dt.cols, dt.colblock, dt.chunk_start, dt.chunk_dest, dt.run_chunk,
        dt.split_run, dt.run_rowgroup, x, *part, y, idx, coeff,
    )
    _launch("hbp_argmax", "hbp_spmm_fused_argmax_launch", tensors, dt, x,
            (n_chunks, dt.split_run.shape[0]), k, *g.launch_args)


def _partials_launch(fn_name: str, dt, x: torch.Tensor, out: torch.Tensor, *k: int,
                     geometry: Optional[PartialsGeometry] = None) -> None:
    """Launch a partials kernel (sum or max) into ``out`` in ``geometry``
    (default: the one :func:`partials_geometry` picks)."""
    g = geometry or _default_geometry(dt, dt.n_tiles, k[0] if k else 1, (x, out))
    tensors = (dt.data, dt.cols, dt.colblock, x, out)
    _launch("hbp_partials", fn_name, tensors, dt, x, (dt.n_tiles,), *k, *g.launch_args)


def hbp_spmv_fused(dt, x: torch.Tensor) -> torch.Tensor:
    """Fused-combine HBP SpMV, hashed row order ``[n_rowgroups, group]``."""
    _check(dt, x, 1, "hbp_spmv_fused")
    if x.device.type == "cpu":
        return hbp_spmv_fused_plain(dt, x)
    group = dt.data.shape[1]
    y = torch.zeros((dt.n_rowgroups, group), dtype=torch.float32, device=x.device)
    if dt.run_rowgroup.shape[0] == 0:
        return y  # no tiles: nothing to launch
    _fused_launch("hbp_spmv_fused_launch", dt, x, y)
    hbp_spmv_fused.launches += 1
    return y


def hbp_spmm_fused(dt, x: torch.Tensor) -> torch.Tensor:
    """Fused-combine HBP SpMM, hashed row order ``[n_rowgroups, group, k]``."""
    _check(dt, x, 2, "hbp_spmm_fused")
    if x.device.type == "cpu":
        return hbp_spmm_fused_plain(dt, x)
    k = x.shape[1]
    group = dt.data.shape[1]
    y = torch.zeros((dt.n_rowgroups, group, k), dtype=torch.float32, device=x.device)
    if dt.run_rowgroup.shape[0] == 0 or k == 0:
        return y
    _fused_launch("hbp_spmm_fused_launch", dt, x, y, k)
    hbp_spmm_fused.launches += 1
    return y


def hbp_spmm_fused_max(dt, x: torch.Tensor) -> torch.Tensor:
    """Fused-combine HBP SpMM under the max monoid, hashed row order
    ``[n_rowgroups, group, k]``.

    The output is filled with ``-inf`` before the launch, so row groups
    that own no tiles (which the kernel never writes) carry the monoid's
    identity like rows with no live entry; ``ops`` maps ``-inf`` to 0 once,
    after assembly, and the plain version gives the same bits.
    """
    _check(dt, x, 2, "hbp_spmm_fused_max")
    if x.device.type == "cpu":
        return hbp_spmm_fused_max_plain(dt, x)
    k = x.shape[1]
    group = dt.data.shape[1]
    y = torch.full(
        (dt.n_rowgroups, group, k), float("-inf"), dtype=torch.float32, device=x.device
    )
    if dt.run_rowgroup.shape[0] == 0 or k == 0:
        return y
    _fused_max(dt, x, y)
    hbp_spmm_fused_max.launches += 1
    return y


def hbp_spmm_fused_argmax(dt, x: torch.Tensor):
    """The max-monoid SpMM with its winners, hashed row order: ``(y, idx,
    coeff)``, each ``[n_rowgroups, group, k]`` (``idx`` int32).

    ``y`` is :func:`hbp_spmm_fused_max`'s, bit for bit; ``idx`` the lowest
    global column whose live slot's product equals ``y`` (``+0.0`` equal to
    ``-0.0``) and ``coeff`` that slot's stored value, ``(-1, 0)`` where a
    row has no live slot or its max is NaN.  The outputs are filled with
    ``(-inf, -1, 0)`` before the launch, for the row groups that own no
    tiles; ``ops`` maps ``-inf`` in ``y`` to 0 after assembly.
    """
    _check(dt, x, 2, "hbp_spmm_fused_argmax")
    if x.device.type == "cpu":
        return hbp_spmm_fused_argmax_plain(dt, x)
    k = x.shape[1]
    shape = (dt.n_rowgroups, dt.data.shape[1], k)
    y = torch.full(shape, float("-inf"), dtype=torch.float32, device=x.device)
    idx = torch.full(shape, -1, dtype=torch.int32, device=x.device)
    coeff = torch.zeros(shape, dtype=torch.float32, device=x.device)
    if dt.run_rowgroup.shape[0] == 0 or k == 0:
        return y, idx, coeff
    _fused_argmax(dt, x, y, idx, coeff)
    hbp_spmm_fused_argmax.launches += 1
    return y, idx, coeff


def _partials_out(dt, x: torch.Tensor, *k: int) -> torch.Tensor:
    # every element is written by the kernel: no fill needed
    group = dt.data.shape[1]
    return torch.empty((dt.n_tiles, group, *k), dtype=torch.float32, device=x.device)


def hbp_spmv_partials(dt, x: torch.Tensor) -> torch.Tensor:
    """Partials HBP SpMV: one partial vector per tile, ``[n_tiles, group]``."""
    _check(dt, x, 1, "hbp_spmv_partials")
    if x.device.type == "cpu":
        return hbp_spmv_partials_plain(dt, x)
    out = _partials_out(dt, x)
    if dt.n_tiles == 0:
        return out
    _partials_launch("hbp_spmv_partials_launch", dt, x, out)
    hbp_spmv_partials.launches += 1
    return out


def hbp_spmm_partials(dt, x: torch.Tensor) -> torch.Tensor:
    """Partials HBP SpMM: one partial block per tile, ``[n_tiles, group, k]``."""
    _check(dt, x, 2, "hbp_spmm_partials")
    if x.device.type == "cpu":
        return hbp_spmm_partials_plain(dt, x)
    k = x.shape[1]
    out = _partials_out(dt, x, k)
    if dt.n_tiles == 0 or k == 0:
        return out
    _partials_launch("hbp_spmm_partials_launch", dt, x, out, k)
    hbp_spmm_partials.launches += 1
    return out


def hbp_spmm_partials_max(dt, x: torch.Tensor, *, runs: bool = False) -> torch.Tensor:
    """Partials HBP SpMM under the max monoid: each tile row's masked lane
    max, ``[n_tiles, group, k]``, ``-inf`` where it has no live slot.

    ``runs=True`` (the entry point's path) also combines each row group's
    run of partials on the card in the same launch call: hashed row order
    ``[n_rowgroups, group, k]``, ``-inf`` where a row has no live entry, as
    :func:`hbp_spmm_fused_max` gives; the partials buffer stays internal.
    """
    _check(dt, x, 2, "hbp_spmm_partials_max")
    if x.device.type == "cpu":
        return hbp_spmm_partials_max_plain(dt, x, runs=runs)
    k = x.shape[1]
    out = _partials_out(dt, x, k)
    if runs:
        group = dt.data.shape[1]
        y = torch.full(
            (dt.n_rowgroups, group, k), float("-inf"), dtype=torch.float32, device=x.device
        )
        if dt.n_tiles == 0 or k == 0:
            return y
        buf = torch.empty(
            (dt.n_split_chunks, group, k), dtype=torch.float32, device=x.device
        )
        g = _default_geometry(dt, dt.n_tiles, k, (x, out))
        tensors = (
            dt.data, dt.cols, dt.colblock, dt.chunk_start, dt.chunk_dest, dt.run_chunk,
            dt.split_run, dt.run_rowgroup, x, out, buf, y,
        )
        counts = (dt.n_tiles, dt.chunk_dest.shape[0], dt.split_run.shape[0])
        _launch("hbp_partials", "hbp_spmm_partials_max_runs_launch", tensors, dt, x,
                counts, k, *g.launch_args)
        hbp_spmm_partials_max.launches += 1
        return y
    if dt.n_tiles == 0 or k == 0:
        return out
    _partials_launch("hbp_spmm_partials_max_launch", dt, x, out, k)
    hbp_spmm_partials_max.launches += 1
    return out


# CSR entries one warp of the SDDMM walks (csrc/hbp_sddmm.cu)
SDDMM_PER_WARP = 32


def hbp_sddmm(indptr: torch.Tensor, cols: torch.Tensor, dy: torch.Tensor, z: torch.Tensor,
              heads: int) -> torch.Tensor:
    """GAT's attention gradient, ``out[e, h] = dy[row(e), h, :] . z[cols[e],
    h, :]`` over every stored entry of a CSR matrix (row = destination):
    ``f32[nnz, heads]``, in CSR order.

    ``indptr`` is i64 ``[n_rows + 1]``, ``cols`` i32 ``[nnz]``, ``dy``
    ``[n_rows, heads * head_dim]`` and ``z`` ``[n_cols, heads * head_dim]``,
    contiguous float32 on one device.  On the card the kernel of
    ``csrc/hbp_sddmm.cu`` (one warp a chunk of ``SDDMM_PER_WARP``
    entries); on the CPU its plain version :func:`.ref.sddmm`, which adds
    each dot product in another order (the two agree to rounding)."""
    if heads <= 0 or dy.dim() != 2 or z.dim() != 2 or dy.shape[1] != z.shape[1] \
            or dy.shape[1] % heads:
        raise ValueError(f"hbp_sddmm: dy {tuple(dy.shape)} and z {tuple(z.shape)} must be "
                         f"[n, heads * head_dim] with heads = {heads}")
    if indptr.dtype != torch.int64 or cols.dtype != torch.int32:
        raise TypeError("hbp_sddmm: indptr must be int64 and cols int32")
    if dy.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError("hbp_sddmm: dy and z must be float32")
    if indptr.numel() != dy.shape[0] + 1:
        raise ValueError(f"hbp_sddmm: indptr has {indptr.numel()} entries for {dy.shape[0]} rows")
    device = dy.device
    if any(t.device != device for t in (indptr, cols, z)):
        raise ValueError("hbp_sddmm: every operand must lie on one device")
    if device.type == "cpu":
        return _ref.sddmm(indptr, cols, dy, z, heads)
    from .build import library

    tensors = (indptr, cols, dy, z)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hbp_sddmm: every operand must be contiguous")
    nnz = cols.numel()
    if nnz >= 2 ** 31:
        raise ValueError(f"hbp_sddmm: {nnz} entries exceed the kernel's 32-bit count")
    out = torch.empty((nnz, heads), dtype=torch.float32, device=device)
    err = library("hbp_sddmm").hbp_sddmm_launch(
        *(t.data_ptr() for t in (*tensors, out)), dy.shape[0], nnz, heads,
        dy.shape[1] // heads, SDDMM_PER_WARP, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hbp_sddmm_launch failed to launch: CUDA error {err}")
    hbp_sddmm.launches += 1
    return out


for _wrapper in (
    hbp_spmv_fused,
    hbp_spmm_fused,
    hbp_spmm_fused_max,
    hbp_spmm_fused_argmax,
    hbp_spmv_partials,
    hbp_spmm_partials,
    hbp_spmm_partials_max,
    hbp_sddmm,
):
    _wrapper.launches = 0
del _wrapper
