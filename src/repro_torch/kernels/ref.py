"""Plain PyTorch references for the HBP tile format.

Torch counterparts of the JAX package's jnp oracles (``repro.kernels.ref``):
the einsum reference, the batch-width-invariant ``"stable"`` lane chain,
the max-monoid lane chain, the argmax SpMM (the forward of max
aggregation's gradient) and the hash-order ``unpermute``.  They run on
any device.

The max monoid is IEEE's maximum, as ``jnp.maximum`` is: NaN wins, and
``+0.0`` ranks above ``-0.0`` whatever their order (:func:`ieee_max`).
``torch.maximum`` on the CPU and ``torch.segment_reduce(..., "max")`` on
every device keep the first of two equal operands instead, so the max
steps here never rely on them for the sign of a zero.

The row-group combine never uses ``index_add_``/``scatter_add_``: on CUDA
those are atomic, so their summation order — and the result's bits —
would change from run to run and with the batch width.  Tiles are sorted
by row group, so the combine is :func:`torch.segment_reduce` over the
contiguous runs, which adds each run's tiles in stream order, one output
element at a time.

:func:`count_traversals` counts walks over the packed (data, cols) tile
stream with their x gathers, as the JAX package's does: each plain
version's lane walk adds one, so the one-pass argmax counts 1 and the
three-pass argmax 3.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "segment_sum_sorted",
    "segment_max_sorted",
    "ieee_max",
    "tile_contrib_ref",
    "hbp_spmv_hashed_ref",
    "tile_contrib_spmm_ref",
    "hbp_spmm_hashed_ref",
    "lane_chain",
    "tile_contrib_spmm_stable",
    "hbp_spmm_hashed_stable",
    "lane_max",
    "tile_contrib_spmm_max",
    "hbp_spmm_hashed_max",
    "hbp_spmm_hashed_argmax",
    "hbp_spmm_hashed_argmax_onepass",
    "count_traversals",
    "unpermute",
    "sddmm",
    "NEGATIVE_SLOPE",
    "rewritten_values",
    "edge_softmax",
    "edge_softmax_backward",
    "edge_softmax_columns",
]

_TRAVERSALS = [0]


def _traverse() -> None:
    _TRAVERSALS[0] += 1


@contextlib.contextmanager
def count_traversals():
    """Context manager yielding a 1-element list that, on exit, holds the
    number of tile-stream traversals the plain versions made inside the
    block."""
    start = _TRAVERSALS[0]
    box = [0]
    try:
        yield box
    finally:
        box[0] = _TRAVERSALS[0] - start


def _run_lengths(rowgroup, n_rowgroups, lengths):
    """Tiles per row group, counted from a sorted ``rowgroup`` unless given."""
    if lengths is not None:
        return lengths
    rg = rowgroup.long()
    if rg.numel() > 1 and bool((rg[1:] < rg[:-1]).any()):
        raise ValueError("rowgroup must be sorted for the run combine")
    return torch.bincount(rg, minlength=n_rowgroups)


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
    lengths = _run_lengths(rowgroup, n_rowgroups, lengths)
    if contrib.shape[0] == 0:
        return contrib.new_zeros((n_rowgroups,) + tuple(contrib.shape[1:]))
    return torch.segment_reduce(contrib, "sum", lengths=lengths, axis=0, unsafe=checked)


def segment_max_sorted(
    contrib: torch.Tensor,  # [T, ...], sorted by row group
    rowgroup: torch.Tensor,  # [T], non-decreasing
    n_rowgroups: int,
    lengths: Optional[torch.Tensor] = None,  # i64[n_rowgroups]: tiles per group
) -> torch.Tensor:
    """Segment max over row-group runs -> ``[n_rowgroups, ...]``.

    The max is exact in any order; groups with no tiles come out ``-inf``
    (the monoid's identity, passed explicitly as the reduction's initial
    value), for the caller to map to 0 after assembly.  NaN wins, and a
    run whose max is a zero gives ``+0.0`` if any of its elements is
    ``+0.0``: ``segment_reduce`` keeps the first of two equal operands, so
    a second, narrow pass finds the runs that hold a ``+0.0``.  The plain
    version of the run combine; on the card the partials max entry point
    combines in a kernel (``hbp_spmm_partials_max(runs=True)``).
    """
    checked = lengths is not None
    lengths = _run_lengths(rowgroup, n_rowgroups, lengths)
    if contrib.shape[0] == 0:
        return contrib.new_full((n_rowgroups,) + tuple(contrib.shape[1:]), float("-inf"))
    y = torch.segment_reduce(
        contrib, "max", lengths=lengths, axis=0, unsafe=checked, initial=float("-inf")
    )
    # +0.0 is the one float whose bits are all zero
    pos_zero = (contrib.view(torch.int32) == 0).to(torch.float16)
    has_pos_zero = torch.segment_reduce(
        pos_zero, "max", lengths=lengths, axis=0, unsafe=checked, initial=0.0
    )
    return y.masked_fill_((has_pos_zero > 0) & (y == 0), 0.0)


def _segment_int(
    values: torch.Tensor,  # i32[T, ...], sorted by row group
    reduce: str,  # "max" or "min"
    rowgroup: torch.Tensor,
    n_rowgroups: int,
    fill: int,  # the result of a group with no tiles
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Segment max or min of int32 ``values`` over row-group runs ->
    i32 ``[n_rowgroups, ...]``.  ``segment_reduce`` takes floating types
    only; float64 holds every int32 exactly, so the reduction runs there.
    """
    checked = lengths is not None
    lengths = _run_lengths(rowgroup, n_rowgroups, lengths)
    if values.shape[0] == 0:
        return values.new_full((n_rowgroups,) + tuple(values.shape[1:]), fill)
    out = torch.segment_reduce(
        values.double(), reduce, lengths=lengths, axis=0, unsafe=checked, initial=float(fill)
    )
    return out.to(torch.int32)


def ieee_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IEEE maximum: NaN if either operand is NaN, and
    ``+0.0`` above ``-0.0`` in either order (``jnp.maximum``'s semantics).

    Equal operands that are not zeros have the same bits, and the AND of
    ``+0.0``'s and ``-0.0``'s bits is ``+0.0``'s, so where ``a == b`` the
    AND of the bit patterns is the maximum.
    """
    tie = (a.view(torch.int32) & b.view(torch.int32)).view(a.dtype)
    return torch.where(a == b, tie, torch.maximum(a, b))


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
    _traverse()
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
    _traverse()
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
    _traverse()
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


def lane_max(
    colblock: torch.Tensor,  # i32[T]
    data: torch.Tensor,  # f32[T, group, lane]
    cols: torch.Tensor,  # i32[T, group, lane]
    x_flat: torch.Tensor,  # f32[n_x, k]: x rows in global column order
    col_block: int,
) -> torch.Tensor:
    """Max-monoid contributions ``[T, group, k]``: per tile row, the max of
    ``a * x`` over its live slots, ``-inf`` where it has none.

    A slot is live iff its stored value is nonzero: padded slots and
    explicitly stored zeros are masked to ``-inf`` (the identity of
    ``max``) instead of contributing ``0 * x = 0``, which would beat every
    all-negative row.  ``max`` is exact, so this one chain is the plain
    version, the ``"stable"``/``"reference"`` path and the oracle at once;
    each step is :func:`ieee_max`.
    """
    _traverse()
    base = colblock.long()[:, None] * col_block  # [T, 1]
    cols = cols.long()
    neg = torch.tensor(float("-inf"), dtype=x_flat.dtype, device=x_flat.device)

    def term(lane):
        d = data[:, :, lane, None]  # [T, group, 1]
        return torch.where(d != 0, d * x_flat[base + cols[:, :, lane]], neg)

    acc = term(0)
    for lane in range(1, data.shape[2]):
        acc = ieee_max(acc, term(lane))
    return acc


def tile_contrib_spmm_max(
    colblock, data, cols, x_blocked: torch.Tensor  # f32[n_col_blocks, col_block, k]
) -> torch.Tensor:
    """Max-monoid SpMM contributions ``[T, group, k]`` (``-inf`` where a tile
    row has no live slot)."""
    n_cb, col_block, k = x_blocked.shape
    return lane_max(colblock, data, cols, x_blocked.reshape(n_cb * col_block, k), col_block)


def hbp_spmm_hashed_max(
    rowgroup, colblock, data, cols, x_blocked, *, n_rowgroups: int, lengths=None
) -> torch.Tensor:
    """Max-monoid SpMM + combine, hashed row order ``[n_rowgroups, group, k]``.

    Rows with no live entry (and row groups with no tiles) are ``-inf``,
    the monoid's identity, for the caller to map to 0."""
    contrib = tile_contrib_spmm_max(colblock, data, cols, x_blocked)
    return segment_max_sorted(contrib, rowgroup, n_rowgroups, lengths)


_INT_MAX = torch.iinfo(torch.int32).max
_INT_MIN = torch.iinfo(torch.int32).min


def _slot(colblock, data, cols, x_flat, col_block, lane):
    """Lane ``lane`` of every tile row: its stored value ``d`` ``[T, group,
    1]``, its global column (i32 ``[T, group, 1]``) and ``d * x``
    ``[T, group, k]``."""
    d = data[:, :, lane, None]
    gcol = colblock.long()[:, None] * col_block + cols[:, :, lane].long()
    return d, gcol[..., None].to(torch.int32), d * x_flat[gcol]


def hbp_spmm_hashed_argmax(
    rowgroup, colblock, data, cols, x_blocked, *, n_rowgroups: int, lengths=None
):
    """Max-monoid SpMM that also reports which stored entry won, by three
    passes over the tile stream: ``(y, idx, coeff)``, each
    ``[n_rowgroups, group, k]`` in hashed row order.

    * ``y`` — :func:`hbp_spmm_hashed_max` (``-inf`` where a row has no
      live entry);
    * ``idx`` — the global column of the winning stored entry, ties to the
      lowest column (``-1`` where the row has none);
    * ``coeff`` — that entry's stored value (0 where the row has none).

    Pass 2 reduces ``-column`` under the max over the slots whose product
    attained ``y``, pass 3 reads the winner's coefficient.  The
    equivalence oracle of :func:`hbp_spmm_hashed_argmax_onepass`.
    """
    n_cb, col_block, k = x_blocked.shape
    x_flat = x_blocked.reshape(n_cb * col_block, k)
    y = hbp_spmm_hashed_max(
        rowgroup, colblock, data, cols, x_blocked, n_rowgroups=n_rowgroups, lengths=lengths
    )
    rg = rowgroup.long()
    y_t = y[rg]  # [T, group, k]: each tile's target row values

    # pass 2: the lowest winning global column, as a max of the negated id
    _traverse()
    acc = None
    for lane in range(data.shape[2]):
        d, gcol, prod = _slot(colblock, data, cols, x_flat, col_block, lane)
        win = (d != 0) & (prod == y_t)
        term = torch.where(win, -gcol, _INT_MIN)
        acc = term if acc is None else torch.maximum(acc, term)
    neg_idx = _segment_int(acc, "max", rowgroup, n_rowgroups, _INT_MIN, lengths)
    live = neg_idx > _INT_MIN  # also False for row groups with no tiles
    idx = torch.where(live, -neg_idx, -1)

    # pass 3: the winner's stored coefficient (one per (row, column))
    _traverse()
    idx_t = idx[rg]
    neg = torch.tensor(float("-inf"), dtype=data.dtype, device=data.device)
    acc_c = None
    for lane in range(data.shape[2]):
        d = data[:, :, lane, None]
        gcol = (colblock.long()[:, None] * col_block + cols[:, :, lane].long())[..., None]
        term = torch.where((d != 0) & (gcol == idx_t), d.expand(idx_t.shape), neg)
        acc_c = term if acc_c is None else ieee_max(acc_c, term)
    coeff = segment_max_sorted(acc_c, rowgroup, n_rowgroups, lengths)
    return y, idx, torch.where(live, coeff, 0.0)


def hbp_spmm_hashed_argmax_onepass(
    rowgroup, colblock, data, cols, x_blocked, *, n_rowgroups: int, lengths=None
):
    """The argmax SpMM in one pass over the tile stream: the same
    ``(y, idx, coeff)`` as :func:`hbp_spmm_hashed_argmax`, bit for bit.

    Each lane step advances a paired ``(value, index, coefficient)``
    payload: a lane term displaces the accumulator iff its value is
    greater, or equal with a lower column (``-0.0`` and ``+0.0`` compare
    equal there).  The value chain is the literal :func:`ieee_max`
    sequence of :func:`lane_max`, so ``y`` is bitwise
    :func:`hbp_spmm_hashed_max`'s.  Dead slots carry the int32-max column
    so the tie-break never selects them.  The per-tile payloads
    ``[T, group, k]`` are then combined over each row group's run without
    touching the tile stream again.
    """
    _traverse()
    n_cb, col_block, k = x_blocked.shape
    x_flat = x_blocked.reshape(n_cb * col_block, k)
    neg = torch.tensor(float("-inf"), dtype=data.dtype, device=data.device)

    def lane_term(lane):
        d, gcol, prod = _slot(colblock, data, cols, x_flat, col_block, lane)
        live = d != 0
        # the index and coefficient stay [T, group, 1] until a take
        # broadcasts them over k
        return (torch.where(live, prod, neg), torch.where(live, gcol, _INT_MAX),
                torch.where(live, d, 0.0))

    acc_v, acc_i, acc_c = lane_term(0)
    acc_i, acc_c = acc_i.expand(acc_v.shape), acc_c.expand(acc_v.shape)
    for lane in range(1, data.shape[2]):
        v, i, c = lane_term(lane)
        take = (v > acc_v) | ((v == acc_v) & (i < acc_i))
        acc_v = ieee_max(acc_v, v)
        acc_i = torch.where(take, i, acc_i)
        acc_c = torch.where(take, c, acc_c)

    # the row-group combine of the per-tile payloads
    rg = rowgroup.long()
    y = segment_max_sorted(acc_v, rowgroup, n_rowgroups, lengths)
    attain = acc_v == y[rg]  # a tile's winner attains the row's max
    idx_min = _segment_int(
        torch.where(attain, acc_i, _INT_MAX), "min", rowgroup, n_rowgroups, _INT_MAX, lengths
    )
    live = idx_min < _INT_MAX  # also False for row groups with no tiles
    idx = torch.where(live, idx_min, -1)
    hit = attain & (acc_i == idx[rg])
    coeff = segment_max_sorted(torch.where(hit, acc_c, neg), rowgroup, n_rowgroups, lengths)
    return y, idx, torch.where(live, coeff, 0.0)


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


# products of one edge block of the plain SDDMM: [entries, heads * head_dim]
_SDDMM_BLOCK = 1 << 24


def sddmm(indptr: torch.Tensor, cols: torch.Tensor, dy: torch.Tensor, z: torch.Tensor,
          heads: int) -> torch.Tensor:
    """The sampled dense-dense product of GAT's attention gradient:
    ``out[e, h] = dy[row(e), h, :] . z[cols[e], h, :]`` for every stored
    entry ``e`` of a CSR matrix (row = destination), ``[nnz, heads]``, with
    ``dy`` and ``z`` ``[n, heads * head_dim]`` (the plain version of
    ``csrc/hbp_sddmm.cu``).  Gathers ``[entries, heads, head_dim]`` rows of
    both in edge blocks of at most ``_SDDMM_BLOCK`` products."""
    nnz, width = cols.numel(), dy.shape[1]
    rows = _csr_rows(indptr)
    cols = cols.long()
    out = torch.empty((nnz, heads), dtype=dy.dtype, device=dy.device)
    step = max(1, _SDDMM_BLOCK // max(width, 1))
    for e0 in range(0, nnz, step):
        a = dy[rows[e0:e0 + step]].view(-1, heads, width // heads)
        b = z[cols[e0:e0 + step]].view(-1, heads, width // heads)
        out[e0:e0 + step] = (a * b).sum(-1)
    return out


# GAT's LeakyReLU slope on the edge scores (Veličković et al. 2018)
NEGATIVE_SLOPE = 0.2


def _csr_rows(indptr: torch.Tensor) -> torch.Tensor:
    """Each stored entry's row (i64 ``[nnz]``) from a CSR's ``indptr``."""
    n_rows = indptr.numel() - 1
    return torch.repeat_interleave(torch.arange(n_rows, device=indptr.device),
                                   indptr[1:] - indptr[:-1])


def rewritten_values(entry: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``[heads, n_slots]`` copies of a tile set's values: slot s of copy h
    holds ``values[entry[s], h]`` (``values`` ``[nnz, heads]``), 0 where
    ``entry[s] < 0`` (the padding); the plain version of
    ``csrc/hbp_softmax.cu``'s rewrite."""
    picked = values.index_select(0, entry.clamp(min=0).long())
    return torch.where((entry >= 0)[:, None], picked, 0.0).t().contiguous()


def _edge_scores(rows, cols, s_src, s_dst) -> torch.Tensor:
    """``s_dst[row(e)] + s_src[col(e)]``, ``[nnz, H]``: the scores before
    the LeakyReLU."""
    return s_dst.index_select(0, rows) + s_src.index_select(0, cols)


def edge_softmax(indptr, cols, s_src, s_dst):
    """GAT's attention weights ``α`` (the plain version of
    ``csrc/hbp_softmax.cu``'s forward): ``[nnz, H]`` in CSR order (row =
    destination), the LeakyReLU of the edge scores softmaxed over each
    row's entries with the row's maximum subtracted."""
    rows = _csr_rows(indptr)
    e = F.leaky_relu(_edge_scores(rows, cols, s_src, s_dst), NEGATIVE_SLOPE)
    top = torch.full_like(s_dst, float("-inf")).scatter_reduce_(
        0, rows[:, None].expand_as(e), e, "amax")
    ex = (e - top.index_select(0, rows)).exp_()
    total = torch.zeros_like(s_dst).index_add_(0, rows, ex)
    return ex.div_(total.index_select(0, rows))


def edge_softmax_backward(indptr, cols, s_src, s_dst, alpha, d_alpha):
    """The softmax's and LeakyReLU's backward by rows (the plain version of
    ``csrc/hbp_softmax.cu``'s backward): ``(de, d_dst)`` with ``de = α (ᾱ -
    Σ_row α ᾱ)``, times the slope where the score is not positive, and
    ``d_dst`` its row sums."""
    rows = _csr_rows(indptr)
    weighted = torch.zeros_like(s_dst).index_add_(0, rows, alpha * d_alpha)
    de = alpha * (d_alpha - weighted.index_select(0, rows))
    de = torch.where(_edge_scores(rows, cols, s_src, s_dst) > 0, de, NEGATIVE_SLOPE * de)
    return de, torch.zeros_like(s_dst).index_add_(0, rows, de)


def edge_softmax_columns(indptr_T, perm_T, de):
    """``d_src``, the column sums of ``de`` (``[n_cols, H]``), over Aᵀ's
    CSR (``indptr_T``; position p holds A's entry ``perm_T[p]``): each
    column's entries are added in A's entry order (the plain version of
    ``csrc/hbp_softmax.cu``'s column launch)."""
    out = torch.zeros((indptr_T.numel() - 1, de.shape[1]), dtype=de.dtype, device=de.device)
    return out.index_add_(0, _csr_rows(indptr_T), de.index_select(0, perm_T.long()))
