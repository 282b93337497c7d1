"""Plain PyTorch references for the HBP tile format.

Torch counterparts of the JAX package's jnp oracles (``repro.kernels.ref``):
the einsum reference, the batch-width-invariant ``"stable"`` lane chain,
and the hash-order ``unpermute``.  They run on any device.

The row-group combine never uses ``index_add_``/``scatter_add_``: on CUDA
those are atomic, so their summation order — and the result's bits —
would change from run to run and with the batch width.  Tiles are sorted
by row group, so the combine is :func:`torch.segment_reduce` over the
contiguous runs, which adds each run's tiles in stream order, one output
element at a time.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "segment_sum_sorted",
    "tile_contrib_ref",
    "hbp_spmv_hashed_ref",
    "tile_contrib_spmm_ref",
    "hbp_spmm_hashed_ref",
    "lane_chain",
    "tile_contrib_spmm_stable",
    "hbp_spmm_hashed_stable",
    "unpermute",
]


def segment_sum_sorted(
    contrib: torch.Tensor,  # [T, ...], sorted by row group
    rowgroup: torch.Tensor,  # [T], non-decreasing
    n_rowgroups: int,
    lengths: Optional[torch.Tensor] = None,  # i64[n_rowgroups]: tiles per group
) -> torch.Tensor:
    """Deterministic segment sum over row-group runs -> ``[n_rowgroups, ...]``.

    Each run is summed in stream order; groups with no tiles come out 0.
    ``lengths`` (tiles per row group) may be passed precomputed, as the
    staged device tiles do; otherwise it is counted from ``rowgroup``,
    which must then be sorted.
    """
    checked = lengths is not None  # staged lengths were validated on the host
    if lengths is None:
        rg = rowgroup.long()
        if rg.numel() > 1 and bool((rg[1:] < rg[:-1]).any()):
            raise ValueError("rowgroup must be sorted for the run combine")
        lengths = torch.bincount(rg, minlength=n_rowgroups)
    if contrib.shape[0] == 0:
        return contrib.new_zeros((n_rowgroups,) + tuple(contrib.shape[1:]))
    return torch.segment_reduce(contrib, "sum", lengths=lengths, axis=0, unsafe=checked)


def _gather(x_flat, colblock, cols, col_block):
    """x rows of every tile slot: ``[T, group, lane, k]``."""
    base = colblock.long()[:, None, None] * col_block
    return x_flat[base + cols.long()]


def tile_contrib_ref(
    colblock: torch.Tensor,  # i32[T]
    data: torch.Tensor,  # f32[T, group, lane]
    cols: torch.Tensor,  # i32[T, group, lane]
    x_blocked: torch.Tensor,  # f32[n_col_blocks, col_block]
) -> torch.Tensor:
    """Per-tile partial results ``[T, group]`` — oracle of the SpMV part."""
    n_cb, col_block = x_blocked.shape
    gathered = _gather(x_blocked.reshape(n_cb * col_block), colblock, cols, col_block)
    return (data * gathered).sum(dim=2)


def hbp_spmv_hashed_ref(
    rowgroup, colblock, data, cols, x_blocked, *, n_rowgroups: int, lengths=None
) -> torch.Tensor:
    """Full SpMV + combine oracle, hashed row order ``[n_rowgroups, group]``."""
    contrib = tile_contrib_ref(colblock, data, cols, x_blocked)
    return segment_sum_sorted(contrib, rowgroup, n_rowgroups, lengths)


def tile_contrib_spmm_ref(
    colblock: torch.Tensor,  # i32[T]
    data: torch.Tensor,  # f32[T, group, lane]
    cols: torch.Tensor,  # i32[T, group, lane]
    x_blocked: torch.Tensor,  # f32[n_col_blocks, col_block, k]
) -> torch.Tensor:
    """Per-tile partial blocks ``[T, group, k]`` — oracle of the SpMM part."""
    n_cb, col_block, k = x_blocked.shape
    gathered = _gather(x_blocked.reshape(n_cb * col_block, k), colblock, cols, col_block)
    return torch.einsum("tgl,tglk->tgk", data, gathered)


def hbp_spmm_hashed_ref(
    rowgroup, colblock, data, cols, x_blocked, *, n_rowgroups: int, lengths=None
) -> torch.Tensor:
    """Full multi-RHS SpMM + combine oracle, ``[n_rowgroups, group, k]``."""
    contrib = tile_contrib_spmm_ref(colblock, data, cols, x_blocked)
    return segment_sum_sorted(contrib, rowgroup, n_rowgroups, lengths)


def lane_chain(
    colblock: torch.Tensor,  # i32[T]
    data: torch.Tensor,  # f32[T, group, lane]
    cols: torch.Tensor,  # i32[T, group, lane]
    x_flat: torch.Tensor,  # f32[n_x, k]: x rows in global column order
    col_block: int,
) -> torch.Tensor:
    """Per-tile contributions ``[T, group, k]`` as an ordered lane chain.

    ``acc = d0*x0; acc = acc + d1*x1; ...`` over lanes in order, each step
    an elementwise multiply and add over ``[T, group, k]``.  Elementwise
    IEEE operations give a column the same bits whatever the other columns
    hold or how many there are, so the result is invariant to batch width
    and zero padding.  Slot ``(t, g, l)`` reads x row
    ``colblock[t] * col_block + cols[t, g, l]``; ``x_flat`` need not be
    padded to whole column blocks.
    """
    base = colblock.long()[:, None] * col_block  # [T, 1]
    cols = cols.long()
    acc = data[:, :, 0, None] * x_flat[base + cols[:, :, 0]]
    for lane in range(1, data.shape[2]):
        acc = acc + data[:, :, lane, None] * x_flat[base + cols[:, :, lane]]
    return acc


def tile_contrib_spmm_stable(
    colblock, data, cols, x_blocked: torch.Tensor  # f32[n_col_blocks, col_block, k]
) -> torch.Tensor:
    """Batch-width-invariant SpMM contributions ``[T, group, k]``
    (the counterpart of the JAX ordered lane chain)."""
    n_cb, col_block, k = x_blocked.shape
    return lane_chain(colblock, data, cols, x_blocked.reshape(n_cb * col_block, k), col_block)


def hbp_spmm_hashed_stable(
    rowgroup, colblock, data, cols, x_blocked, *, n_rowgroups: int, lengths=None
) -> torch.Tensor:
    """Full batch-width-invariant SpMM + combine, ``[n_rowgroups, group, k]``."""
    contrib = tile_contrib_spmm_stable(colblock, data, cols, x_blocked)
    return segment_sum_sorted(contrib, rowgroup, n_rowgroups, lengths)


def unpermute(y_hashed: torch.Tensor, perm: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Undo the hash reordering: slot s computed original row ``perm[s]``.

    ``y_hashed`` is ``[n_rowgroups, group]`` (SpMV) or
    ``[n_rowgroups, group, k]`` (SpMM); ``perm`` (int64) maps slots of the
    flattened hashed order to original row ids over the padded row space.
    ``perm`` is a permutation, so the indexed write has no collisions and
    is deterministic on every device.
    """
    flat = y_hashed.reshape((-1,) + tuple(y_hashed.shape[2:]))
    padded = flat.new_zeros((perm.shape[0],) + tuple(flat.shape[1:]))
    padded[perm] = flat
    return padded[:n_rows]
