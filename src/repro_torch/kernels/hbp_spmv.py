"""Fused-combine HBP SpMV/SpMM: the Hopper kernels and their plain versions.

Each wrapper takes staged tiles (:class:`~repro_torch.kernels.ops.DeviceTiles`)
and an unpadded right-hand side, and returns the product in hashed row
order:

* :func:`hbp_spmv_fused` — ``x: f32[n_cols]`` -> ``f32[n_rowgroups, group]``
  (replaces ``_fused_kernel`` / ``hbp_spmv_fused`` in
  ``src/repro/kernels/hbp_spmv.py``);
* :func:`hbp_spmm_fused` — ``x: f32[n_cols, k]`` ->
  ``f32[n_rowgroups, group, k]``, any k in one launch (replaces
  ``_fused_spmm_kernel`` / ``hbp_spmm_fused``).

On a CUDA tensor a wrapper launches its kernel (``csrc/hbp_spmv.cu``,
whose header note gives the design and what bounds it) or raises; on a
CPU tensor it runs the plain PyTorch version beside it.  Nothing falls
back from one to the other.  Each wrapper counts its kernel launches in
a plain integer attribute, ``launches``.

Slot ``(t, g, l)`` reads x row ``colblock[t] * col_block + cols[t, g, l]``.
Tile packing only emits tiles of column blocks that hold entries, so
every such row — padded slots included, which carry column 0 — lies below
``n_cols``, and x needs no padding to whole column blocks;
``ops.device_tiles`` checks this bound once when it stages the tiles.
"""
from __future__ import annotations

import torch

from . import ref as _ref

__all__ = [
    "hbp_spmv_fused",
    "hbp_spmm_fused",
    "hbp_spmv_fused_plain",
    "hbp_spmm_fused_plain",
]


def hbp_spmm_fused_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused SpMM: the same terms in the same order.

    Each tile's lanes are chained in order (:func:`ref.lane_chain`), then
    each row group's tiles are summed in stream order over its run.  The
    kernel keeps one chain across the whole run and fuses each multiply
    and add, so the two agree to rounding, not bitwise.  Every step is
    elementwise or a per-element run sum, so a column's bits do not
    depend on the batch width here either.
    """
    contrib = _ref.lane_chain(dt.colblock, dt.data, dt.cols, x, dt.col_block)
    return _ref.segment_sum_sorted(contrib, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths)


def hbp_spmv_fused_plain(dt, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused SpMV: the plain SpMM at k = 1."""
    return hbp_spmm_fused_plain(dt, x[:, None])[..., 0]


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


def _launch(fn_name: str, dt, x: torch.Tensor, y: torch.Tensor, *extra: int) -> None:
    from .build import library

    for t in (dt.data, dt.cols, dt.colblock, dt.run_start, dt.run_rowgroup, x, y):
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: every operand must be contiguous")
    if dt.data.dtype != torch.float32 or dt.cols.dtype != torch.int32:
        raise TypeError(f"{fn_name}: tiles must be f32 data and i32 cols")
    _, group, lane = dt.data.shape
    n_runs = dt.run_rowgroup.shape[0]
    err = getattr(library("hbp_spmv"), fn_name)(
        dt.data.data_ptr(), dt.cols.data_ptr(), dt.colblock.data_ptr(),
        dt.run_start.data_ptr(), dt.run_rowgroup.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_runs, group, lane, dt.col_block, *extra, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


def hbp_spmv_fused(dt, x: torch.Tensor) -> torch.Tensor:
    """Fused-combine HBP SpMV, hashed row order ``[n_rowgroups, group]``."""
    _check(dt, x, 1, "hbp_spmv_fused")
    if x.device.type == "cpu":
        return hbp_spmv_fused_plain(dt, x)
    group = dt.data.shape[1]
    y = torch.zeros((dt.n_rowgroups, group), dtype=torch.float32, device=x.device)
    if dt.run_rowgroup.shape[0] == 0:
        return y  # no tiles: nothing to launch
    _launch("hbp_spmv_fused_launch", dt, x, y)
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
    _launch("hbp_spmm_fused_launch", dt, x, y, k)
    hbp_spmm_fused.launches += 1
    return y


hbp_spmv_fused.launches = 0
hbp_spmm_fused.launches = 0
