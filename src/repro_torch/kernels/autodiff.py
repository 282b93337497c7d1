"""Differentiable HBP aggregation: autograd functions that stay on the
kernel path.

Autograd through a plain aggregation would record the SpMM's gathers and
segment sums, and cannot enter a CUDA kernel at all.  But the backward of
sparse aggregation has a closed form that is itself an HBP SpMM:

* ``sum``:  ``y = A @ x``            → ``x̄ = Aᵀ @ ȳ``
* ``mean``: ``y = (A @ x) / d``      → ``x̄ = Aᵀ @ (ȳ / d)``
* ``max``:  ``y[i,c] = max_j a_ij x[j,c]`` → route ``ȳ[i,c]`` to the
  winning neighbor: ``x̄[j*,c] += a_{i,j*} ȳ[i,c]``

so training keeps the paper's admit-once / multiply-many economics: A and
Aᵀ are each one hash-based preprocessing pass (:func:`hbp_transpose`
builds the pair together), and every backward step is one more launch of
the kernels the forward uses (the fused or partials SpMM, kernel 2 or 6).

Two flavors, selected by ``mode``, as in the JAX package
(``repro.kernels.autodiff``):

* ``"vjp"`` (default, the training path) — a dual pair of
  :class:`torch.autograd.Function`\\ s: the backward of the A launch *is*
  the Aᵀ launch, and the backward of that is the A launch again, so
  ``create_graph=True`` differentiates to any order.  Cotangents reach
  the kernels as contiguous float32.
* ``"jvp"`` — a Function whose forward-mode rule (``torch.func.jvp``) is
  a second A launch on the tangent.  Its reverse mode is autograd through
  the plain PyTorch version of the forward (the ``"stable"`` chain):
  correct, but not the resident Aᵀ tile stream, as the JAX package's
  reverse mode there transposes the tangent's trace.  Not the training
  path.

``max`` has one Function for both modes: its forward is the paired
(value, index, coefficient) argmax SpMM of
:func:`repro_torch.kernels.ops.hbp_spmm_argmax`, its tangent gathers
``coeff * t[idx]`` and its backward scatters ``coeff * ȳ`` to row
``idx`` (``index_add``; rows with no live entry add an exact 0).  The
scatter is itself differentiable, so order 2 works.  On the card its
atomic adds make the summation order change from run to run: an element
of ``x̄`` that receives ``m`` terms is within ``(m + 1) * 2**-24 *
sum|terms|`` of the exact sum, not bitwise reproducible.

GAT's attention aggregation (:func:`attention_aggregator`) is one Function
over ``(z, s_src, s_dst)`` whose sparse matrix gets new values on every
call: per head ``y_h = α_h z_h`` with ``α[(i, j), h] = softmax_j
LeakyReLU_0.2(s_dst[i, h] + s_src[j, h])`` over each row's stored entries.
The structure is tiled once; each call computes α
(:func:`.hbp_spmv.hbp_edge_softmax`), writes it into a copy of the tile
values a head through the entry maps of :class:`AttentionMaps`
(:func:`.hbp_spmv.hbp_rewrite`) and launches one sum SpMM per head.  The
backward runs the SDDMM ``ᾱ[(i, j), h] = ȳ_i,h · z_j,h``
(:func:`.hbp_spmv.hbp_sddmm`), then the softmax's and LeakyReLU's backward
by A's rows (:func:`.hbp_spmv.hbp_edge_softmax_backward`), the source
scores' gradient by Aᵀ's rows (:func:`.hbp_spmv.hbp_edge_softmax_columns`),
the rewrite of α into copies of Aᵀ's tiles, and one SpMM per head on them
(``z̄_h = α_hᵀ ȳ_h``).  Each of these is a kernel on the card, and each sum
there is taken in a fixed order, without atomics: the same inputs give the
same bits.  It is differentiable once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch import obs
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.tile import HBPTiles, build_tiles, tuned_partition_config

from . import ops
from .hbp_spmv import (
    RowWalk,
    hbp_edge_softmax,
    hbp_edge_softmax_backward,
    hbp_edge_softmax_columns,
    hbp_rewrite,
    hbp_sddmm,
    row_walk,
)
from .ref import NEGATIVE_SLOPE

__all__ = [
    "PairedTiles",
    "hbp_transpose",
    "linear_spmm_vjp",
    "linear_spmm_jvp",
    "argmax_spmm_diff",
    "diff_aggregator",
    "device_diff_aggregator",
    "mean_divisor",
    "needs_transpose",
    "DIFF_MODES",
    "AttentionMaps",
    "attention_maps",
    "rewritten_tiles",
    "attention_aggregator",
    "NEGATIVE_SLOPE",
]

DIFF_MODES = ("vjp", "jvp")


class PairedTiles(NamedTuple):
    """HBP tile formats of a matrix and its transpose, built together.

    ``tiles`` serves the forward launches, ``tiles_T`` the cotangent
    launches.  Each side's geometry is tuned from its own nnz profile.
    ``tiles_T`` may be ``None`` for ops that never launch Aᵀ (see
    :func:`needs_transpose`).
    """

    tiles: HBPTiles
    tiles_T: Optional[HBPTiles]


def hbp_transpose(csr: CSRMatrix, cfg=None, cfg_T=None, *, method: str = "hash") -> PairedTiles:
    """Host-side CSR transpose + paired tile build: ``(tiles, tiles_T)``.

    The transpose is a stable counting sort
    (:meth:`~repro_torch.core.formats.CSRMatrix.transpose`), and each
    side's geometry is tuned from its own nnz profile unless pinned by
    ``cfg`` / ``cfg_T``.  For registry residency (A and Aᵀ linked by
    content hash) use
    :meth:`repro_torch.serving.registry.MatrixRegistry.admit_pair`.
    """
    csr_T = csr.transpose()
    tiles = build_tiles(csr, cfg or tuned_partition_config(csr), method=method)
    tiles_T = build_tiles(csr_T, cfg_T or tuned_partition_config(csr_T), method=method)
    return PairedTiles(tiles, tiles_T)


def _f32(t) -> torch.Tensor:
    """An input or cotangent as the kernels take it: a contiguous float32
    tensor (autograd may hand over expanded or strided tensors, callers
    numpy arrays)."""
    return torch.as_tensor(t, dtype=torch.float32).contiguous()


class _Linear(NamedTuple):
    apply_A: Callable
    apply_AT: Callable


class _SpmmA(torch.autograd.Function):
    """``y = A @ x``; its backward is :class:`_SpmmAT` on the cotangent."""

    @staticmethod
    def forward(ctx, x, pair):
        ctx.pair = pair
        with obs.span("agg.forward"):
            return pair.apply_A(_f32(x))

    @staticmethod
    def backward(ctx, g):
        with obs.span("agg.backward"):
            return _SpmmAT.apply(g, ctx.pair), None


class _SpmmAT(torch.autograd.Function):
    """``x̄ = Aᵀ @ g``; its backward is :class:`_SpmmA` again."""

    @staticmethod
    def forward(ctx, g, pair):
        ctx.pair = pair
        return pair.apply_AT(_f32(g))

    @staticmethod
    def backward(ctx, v):
        return _SpmmA.apply(v, ctx.pair), None


def linear_spmm_vjp(apply_A: Callable, apply_AT: Callable) -> Callable:
    """Wrap a linear map and its transpose as a dual autograd pair.

    The gradient of the result launches ``apply_AT`` on the cotangent, and
    the gradient of *that* launches ``apply_A`` again, so reverse mode
    composes to any order without recording either implementation.
    """
    pair = _Linear(apply_A, apply_AT)
    return lambda x: _SpmmA.apply(x, pair)


class _LinearJvp(torch.autograd.Function):
    """``y = A @ x`` with a forward-mode rule: the tangent is ``A @ t``."""

    @staticmethod
    def forward(x, apply_A, plain_A):
        with obs.span("agg.forward"):
            return apply_A(_f32(x))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.apply_A, ctx.plain_A = inputs
        ctx.save_for_backward(x)

    @staticmethod
    def jvp(ctx, t, *_):
        return ctx.apply_A(_f32(t))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _PlainVjp.apply(g, x, ctx.plain_A), None, None


class _PlainVjp(torch.autograd.Function):
    """``x̄ = Aᵀ g`` by autograd through the plain forward ``plain_A``.  The
    map is linear in ``g``, so its own backward is ``plain_A`` again: the
    plain forward's segment sums have no second derivative of their own."""

    @staticmethod
    def forward(ctx, g, x, plain_A):
        ctx.plain_A = plain_A
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(plain_A(x_), x_, g)
        return gx

    @staticmethod
    def backward(ctx, v):
        return ctx.plain_A(v), None, None


def linear_spmm_jvp(apply_A: Callable, plain_A: Callable) -> Callable:
    """Wrap a linear map as a Function whose tangent is a second launch.

    Forward mode (``torch.func.jvp``) is exact and never differentiates
    the implementation; reverse mode differentiates ``plain_A``, the same
    map in plain PyTorch ops (correct, but not the resident-Aᵀ path —
    prefer :func:`linear_spmm_vjp` for training).
    """
    return lambda x: _LinearJvp.apply(x, apply_A, plain_A)


def _scatter(g: torch.Tensor, idx: torch.Tensor, coeff: torch.Tensor, n_cols: int):
    """``x̄[idx[i, c], c] += coeff[i, c] * g[i, c]`` over the live entries
    (``idx >= 0``; the others add an exact 0 to row 0), ``[n_cols, k]``.
    Out-of-place ``index_add``, so autograd can differentiate it."""
    k = g.shape[1]
    live = idx >= 0
    column = torch.arange(k, device=g.device)
    flat = (idx.clamp(min=0).long() * k + column).reshape(-1)
    src = torch.where(live, coeff * g, 0.0).reshape(-1)
    out = torch.zeros(n_cols * k, dtype=src.dtype, device=g.device)
    return out.index_add(0, flat, src).reshape(n_cols, k)


class _ArgmaxSpmm(torch.autograd.Function):
    """Max aggregation: ``(y, idx, coeff)`` from the argmax SpMM; only
    ``y`` is differentiable."""

    @staticmethod
    def forward(x, dt, passes):
        with obs.span("agg.forward"):
            return ops.hbp_spmm_argmax(dt, _f32(x), passes=passes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, _ = inputs
        _, idx, coeff = output
        ctx.mark_non_differentiable(idx, coeff)
        ctx.save_for_backward(idx, coeff)
        ctx.save_for_forward(idx, coeff)  # what jvp reads
        ctx.n_cols = x.shape[0]

    @staticmethod
    def jvp(ctx, t, *_):
        idx, coeff = ctx.saved_tensors
        picked = torch.gather(_f32(t), 0, idx.clamp(min=0).long())
        return torch.where(idx >= 0, coeff * picked, 0.0), None, None

    @staticmethod
    def backward(ctx, g, *_):
        with obs.span("agg.backward"):
            idx, coeff = ctx.saved_tensors
            return _scatter(g, idx, coeff, ctx.n_cols), None, None


def argmax_spmm_diff(
    dt: ops.DeviceTiles, *, passes: int = 1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Differentiable max aggregation over staged tiles.

    The forward runs the argmax SpMM (``passes=1``: the one-pass paired
    payload; ``passes=3``: the three-pass oracle, the same triple); the
    tangent gathers ``coeff * t[idx]`` and the backward scatters
    ``coeff * ȳ`` back to row ``idx``.  Ties route to the lowest column;
    rows with no live entry give 0 and pass no gradient.
    """
    return lambda x: _ArgmaxSpmm.apply(x, dt, passes)[0]


def mean_divisor(degree, n_rows: int, device=None) -> torch.Tensor:
    """``[n, 1]`` clamped in-degree: the mean over an empty neighborhood is 0.

    The single home of the clamp convention — the graph aggregators and
    the serving registry take it from here, so mean forward and mean
    backward can never disagree about empty rows.  ``device`` defaults to
    the degree's own (the CPU for numpy input).
    """
    d = torch.as_tensor(degree, dtype=torch.float32).reshape(n_rows, 1).clamp(min=1.0)
    return d if device is None else d.to(device)


def device_diff_aggregator(
    dt: ops.DeviceTiles,
    dt_T: Optional[ops.DeviceTiles],
    *,
    strategy: str,
    op: str = "sum",
    degree=None,
    mode: str = "vjp",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Differentiable aggregation closure over already-staged tiles, whose
    sum and mean launch ``strategy`` on both sides.

    ``dt_T`` may be ``None`` for ``op="max"`` (its backward is a scatter,
    not a transpose SpMM) and for ``mode="jvp"``.  This is the layer
    :meth:`~repro_torch.serving.registry.MatrixPlan.diff_aggregator` and
    :func:`repro_torch.graph.aggregate.make_diff_aggregator` both sit on.
    """
    if mode not in DIFF_MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of {DIFF_MODES})")
    if op == "max":
        return argmax_spmm_diff(dt)
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown aggregation {op!r} (expected sum, mean or max)")

    div = None
    if op == "mean":
        if degree is None:
            raise ValueError("op='mean' needs the degree vector (degrees(adj))")
        div = mean_divisor(degree, dt.shape[0], dt.device)

    def apply_A(x):
        y = ops.hbp_spmm(dt, x, strategy=strategy)
        return y / div if div is not None else y

    if mode == "jvp":
        def plain_A(x):
            y = ops.hbp_spmm(dt, x, strategy="stable")
            return y / div if div is not None else y

        return linear_spmm_jvp(apply_A, plain_A)
    if dt_T is None:
        raise ValueError("mode='vjp' needs the transpose tiles (build with hbp_transpose)")

    def apply_AT(g):
        g = g / div if div is not None else g
        return ops.hbp_spmm(dt_T, g, strategy=strategy)

    return linear_spmm_vjp(apply_A, apply_AT)


def needs_transpose(op: str, mode: str) -> bool:
    """Whether the differentiable op launches the Aᵀ tiles at all: only
    the linear ops' ``"vjp"`` backward does — max routes a scatter and
    the ``"jvp"`` flavor re-launches A, so neither pays for a transpose
    build or residency."""
    return mode == "vjp" and op in ("sum", "mean")


def diff_aggregator(
    pair: PairedTiles,
    *,
    op: str = "sum",
    degree=None,
    strategy: Optional[str] = None,
    mode: str = "vjp",
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Stage a :class:`PairedTiles` on ``device`` (default: the card) and
    return a differentiable aggregator.

    The strategy defaults to the device's (:func:`repro_torch.kernels.ops.
    default_strategy`).  The graph-level entry with
    CSR handling and degree defaulting is
    :func:`repro_torch.graph.aggregate.make_diff_aggregator`.  When the op
    never launches Aᵀ (see :func:`needs_transpose`) the transpose side is
    not staged — ``pair.tiles_T`` may then be ``None``.
    """
    tiles, tiles_T = pair
    dev = ops.resolve_device(device)
    if strategy is None:
        strategy = ops.default_strategy(dev)
    ops.check_strategy(strategy)
    stage_t = needs_transpose(op, mode) and tiles_T is not None
    return device_diff_aggregator(
        ops.device_tiles(tiles, dev),
        ops.device_tiles(tiles_T, dev) if stage_t else None,
        strategy=strategy,
        op=op,
        degree=degree,
        mode=mode,
    )


class AttentionMaps(NamedTuple):
    """What the attention aggregation needs beside A's and Aᵀ's staged
    tiles, on the tiles' device: A's CSR structure (row = destination) and
    Aᵀ's, the entry of A that each slot of either tile set holds (from
    :attr:`HBPTiles.slot <repro_torch.core.tile.HBPTiles>`), and the order
    in which the edge softmax's kernels walk A's rows and Aᵀ's."""

    indptr: torch.Tensor  # i64[n_rows + 1]
    cols: torch.Tensor  # i32[nnz]
    entry: torch.Tensor  # i32[A's slots]: the entry of A at data.view(-1)[s], -1 in the padding
    indptr_T: torch.Tensor  # i64[n_cols + 1]: Aᵀ's rows
    perm_T: torch.Tensor  # i32[nnz]: Aᵀ's position p holds A's entry perm_T[p]
    entry_T: torch.Tensor  # i32[Aᵀ's slots]: A's entry (i, j), stored as Aᵀ's (j, i), or -1
    walk: RowWalk  # A's rows
    walk_T: RowWalk  # Aᵀ's rows


def attention_maps(csr: CSRMatrix, tiles: HBPTiles, tiles_T: HBPTiles, device) -> AttentionMaps:
    """The maps of ``csr`` tiled as ``tiles`` and its transpose as
    ``tiles_T`` (built from :meth:`CSRMatrix.transpose`, whose entry order
    is a stable sort of A's on the column), staged on ``device``."""
    if tiles.slot is None or tiles_T.slot is None:
        raise ValueError("the tiles carry no slot map: build them with build_tiles")
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.row_nnz())
    order = np.lexsort((rows, csr.indices))  # Aᵀ's position p holds A's entry order[p]
    indptr_T = np.zeros(csr.shape[1] + 1, dtype=np.int64)
    np.cumsum(np.bincount(csr.indices, minlength=csr.shape[1]), out=indptr_T[1:])

    def entries(t: HBPTiles, held):
        entry = np.full(t.data.size, -1, dtype=np.int32)
        entry[t.slot] = held
        return torch.from_numpy(entry).to(device)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    def walk(indptr):
        w = row_walk(torch.from_numpy(indptr))
        return RowWalk(w.order.to(device), w.n_long)

    return AttentionMaps(put(csr.indptr, torch.int64), put(csr.indices, torch.int32),
                         entries(tiles, np.arange(csr.nnz)), put(indptr_T, torch.int64),
                         put(order, torch.int32), entries(tiles_T, order),
                         walk(csr.indptr), walk(indptr_T))


def rewritten_tiles(dt: ops.DeviceTiles, entry: torch.Tensor,
                    values: torch.Tensor) -> List[ops.DeviceTiles]:
    """One copy of ``dt`` per column of ``values`` (``[nnz, H]``), whose
    data holds ``values[entry[s], h]`` at slot s and 0 in the padded slots
    (:func:`.hbp_spmv.hbp_rewrite`: a kernel on the card); the structure
    tensors are shared.  Counts the stored entries' slots written
    (``values.numel()``) in ``agg.rewritten_slots``."""
    data = hbp_rewrite(entry, values)
    if obs.enabled():
        obs.counter("agg.rewritten_slots").inc(values.numel())
    return [dataclasses.replace(dt, data=row.view_as(dt.data)) for row in data]


class _AttentionPlan(NamedTuple):
    dt: ops.DeviceTiles
    dt_T: ops.DeviceTiles
    maps: AttentionMaps
    strategy: str


def _per_head(tiles: List[ops.DeviceTiles], x: torch.Tensor, strategy: str) -> torch.Tensor:
    """``[tiles[h] @ x_h]`` side by side, ``x_h`` the h-th of ``len(tiles)``
    equal column blocks of ``x``: one SpMM launch a head."""
    width = x.shape[1] // len(tiles)
    return torch.cat([ops.hbp_spmm(t, x[:, h * width:(h + 1) * width], strategy=strategy)
                      for h, t in enumerate(tiles)], dim=1)


class _Attention(torch.autograd.Function):
    """``y = concat_h α_h z_h`` from ``(z, s_src, s_dst)``; see the module
    notes.  Spans: ``agg.attention`` (the softmax and the rewrite of A's
    copies), ``agg.forward`` (the SpMMs); backward ``agg.sddmm``, then
    ``agg.attention_backward`` (the softmax's backward, the score gradients
    and the rewrite of Aᵀ's copies), then ``agg.backward`` (the SpMMs on
    Aᵀ)."""

    @staticmethod
    def forward(ctx, z, s_src, s_dst, att):
        maps = att.maps
        s_src, s_dst = _f32(s_src), _f32(s_dst)
        with obs.span("agg.attention"):
            alpha = hbp_edge_softmax(maps.indptr, maps.cols, maps.walk, s_src, s_dst)
            tiles = rewritten_tiles(att.dt, maps.entry, alpha)
        with obs.span("agg.forward"):
            y = _per_head(tiles, z, att.strategy)
        ctx.save_for_backward(z, s_src, s_dst, alpha)
        ctx.att = att
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        z, s_src, s_dst, alpha = ctx.saved_tensors
        att = ctx.att
        maps = att.maps
        dy = _f32(dy)
        with obs.span("agg.sddmm"):
            d_alpha = hbp_sddmm(maps.indptr, maps.cols, dy, z.contiguous(), alpha.shape[1])
        with obs.span("agg.attention_backward"):
            de, d_dst = hbp_edge_softmax_backward(maps.indptr, maps.cols, maps.walk, s_src,
                                                  s_dst, alpha, d_alpha)
            d_src = hbp_edge_softmax_columns(maps.indptr_T, maps.perm_T, maps.walk_T, de)
            tiles_T = rewritten_tiles(att.dt_T, maps.entry_T, alpha)
        with obs.span("agg.backward"):
            dz = _per_head(tiles_T, dy, att.strategy)
        return dz, d_src, d_dst, None


def attention_aggregator(dt: ops.DeviceTiles, dt_T: ops.DeviceTiles, maps: AttentionMaps,
                         strategy: str) -> Callable:
    """GAT's differentiable attention aggregation over staged tiles of A
    and Aᵀ (one tile set for a symmetric structure): ``agg(z, s_src,
    s_dst)`` with ``z`` ``[n, H * C]`` and the scores ``[n, H]`` returns
    ``[n, H * C]``, head h's columns ``α_h z_h``, every SpMM launched
    under ``strategy``."""
    att = _AttentionPlan(dt, dt_T, maps, strategy)

    def agg(z, s_src, s_dst):
        if z.shape[1] % s_src.shape[1] or s_src.shape != s_dst.shape:
            raise ValueError(f"z {tuple(z.shape)} is not [n, H * C] for scores "
                             f"{tuple(s_src.shape)} and {tuple(s_dst.shape)}")
        return _Attention.apply(z, s_src, s_dst, att)

    return agg
