"""Neighborhood aggregation operators on the HBP tile format.

The message-passing primitive ``agg_{u in N(v)} x_u`` for a whole feature
block X: [n, k] is one HBP SpMM call —

* ``sum``  — ``A @ X`` under the standard (+) combine;
* ``mean`` — ``A @ X`` divided by the in-degree (or serve a row-stochastic
  adjacency and "sum" IS "mean", see :func:`~repro_torch.graph.graph.
  normalize_adjacency`);
* ``max``  — ``A @ X`` under the max monoid (``combine="max"`` in
  :mod:`repro_torch.kernels.ops`): per output row the max of ``a_vu * x_u``
  over stored neighbors, 0 for isolated nodes.

Any feature width is one launch on the card (the kernels flatten the
columns over their threads).  :func:`make_aggregator` stages the tiles on
the device once and returns a closure over them; :func:`plan_aggregator`
serves a graph admitted to a :class:`~repro_torch.serving.registry.
MatrixRegistry`.  Entry points run on the card unless the caller passes
``device="cpu"``; the strategy defaults to the device's (the fused CUDA
kernels on a card, the ``"stable"`` chain on the CPU), as the registry's
does.

:func:`make_diff_aggregator` and :func:`plan_diff_aggregator` are their
differentiable twins (:mod:`repro_torch.kernels.autodiff`): the sum and
mean backward is one SpMM over the transpose tiles, the max backward a
scatter to the winners the forward's argmax SpMM saved.
:func:`make_attention_aggregator` (and, for a served pair,
:meth:`~repro_torch.serving.registry.MatrixPlan.attention_aggregator`)
is GAT's attention aggregation, whose values are new on every call: the
attention weights written into copies of the staged tiles' values.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.formats import CSRMatrix
from repro_torch.core.tile import HBPTiles, build_tiles, tuned_partition_config
from repro_torch.kernels import autodiff, ops
from repro_torch.kernels.autodiff import mean_divisor

from .graph import degrees

__all__ = [
    "AGGREGATIONS",
    "aggregate",
    "make_aggregator",
    "make_diff_aggregator",
    "make_attention_aggregator",
    "mean_divisor",
    "plan_aggregator",
    "plan_diff_aggregator",
]

AGGREGATIONS = ("sum", "mean", "max")

def _check_op(op: str) -> None:
    if op not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {op!r} (expected one of {AGGREGATIONS})")


def _strategy(strategy: Optional[str], device: torch.device) -> str:
    if strategy is None:
        return "fused" if device.type == "cuda" else "stable"
    return strategy


def aggregate(
    tiles: HBPTiles,
    x,  # [n, k] node features
    *,
    op: str = "sum",
    degree=None,
    strategy: Optional[str] = None,
    device=None,
) -> torch.Tensor:
    """One-shot neighborhood aggregation ``[n, k] -> [n, k]``.

    ``degree`` (required for ``op="mean"``) is the per-node in-neighbor
    count, e.g. :func:`repro_torch.graph.graph.degrees` of the same
    adjacency.  For repeated calls over a resident graph prefer
    :func:`make_aggregator` (or a serving plan's ``aggregate``), which
    stage the tiles once.
    """
    _check_op(op)
    if op == "mean" and degree is None:
        raise ValueError("op='mean' needs the degree vector (degrees(adj))")
    dev = ops.resolve_device(device)
    combine = "max" if op == "max" else "sum"
    y = ops.hbp_spmm(
        tiles, x, strategy=_strategy(strategy, dev), combine=combine, device=dev
    )
    if op == "mean":
        y = y / mean_divisor(degree, tiles.shape[0], y.device)
    return y


def make_aggregator(
    adj: CSRMatrix | HBPTiles,
    *,
    op: str = "sum",
    degree=None,
    cfg=None,
    strategy: Optional[str] = None,
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """An aggregation closure over a graph staged on ``device`` once.

    ``adj`` may be the CSR adjacency (tiles are built here, with the
    nnz-profile-tuned geometry unless ``cfg`` pins one) or prebuilt
    :class:`HBPTiles`.  For ``op="mean"`` the degree vector defaults to
    the structural in-degree of the CSR input (it must be passed for
    tiles).  Every call launches on the staged tiles.  The kernel
    strategies record no autograd graph: an x that requires grad raises
    under grad mode; train through :func:`make_diff_aggregator`.
    """
    _check_op(op)
    if isinstance(adj, CSRMatrix):
        if op == "mean" and degree is None:
            degree = degrees(adj)
        tiles = build_tiles(adj, cfg or tuned_partition_config(adj))
    else:
        tiles = adj
        if op == "mean" and degree is None:
            raise ValueError("op='mean' over prebuilt tiles needs degree=")
    dt = ops.device_tiles(tiles, device)  # staged once; every call reuses it
    meta = dict(
        strategy=_strategy(strategy, dt.device),
        combine="max" if op == "max" else "sum",
    )
    div = mean_divisor(degree, tiles.shape[0], dt.device) if op == "mean" else None

    def agg(x) -> torch.Tensor:
        y = ops.hbp_spmm(dt, x, **meta)
        return y / div if div is not None else y

    return agg


def make_diff_aggregator(
    adj,  # CSRMatrix | kernels.autodiff.PairedTiles
    *,
    op: str = "sum",
    degree=None,
    cfg=None,
    cfg_T=None,
    strategy: Optional[str] = None,
    mode: str = "vjp",
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Differentiable twin of :func:`make_aggregator`.

    The returned closure supports autograd without recording the kernels:
    the sum and mean backward is one HBP SpMM against the transpose
    adjacency (built here as a paired tile set, see
    :func:`repro_torch.kernels.autodiff.hbp_transpose`), the max backward
    routes cotangents to the argmax neighbor saved during the forward.
    ``adj`` is the CSR adjacency or a prebuilt
    :class:`~repro_torch.kernels.autodiff.PairedTiles`; for ``op="mean"``
    the degree defaults to the structural in-degree of the CSR input (pass
    ``degree=`` for prebuilt pairs).  For served graphs prefer
    :func:`plan_diff_aggregator` over a registry plan pair.
    """
    _check_op(op)
    if isinstance(adj, CSRMatrix):
        if op == "mean" and degree is None:
            degree = degrees(adj)
        if autodiff.needs_transpose(op, mode):
            pair = autodiff.hbp_transpose(adj, cfg, cfg_T)
        else:  # max and jvp never launch the transpose: skip its build
            tiles = build_tiles(adj, cfg or tuned_partition_config(adj))
            pair = autodiff.PairedTiles(tiles, None)
    else:
        pair = autodiff.PairedTiles(*adj)
        if op == "mean" and degree is None:
            raise ValueError("op='mean' over prebuilt tiles needs degree=")
    return autodiff.diff_aggregator(
        pair, op=op, degree=degree, strategy=strategy, mode=mode, device=device
    )


def plan_aggregator(plan, *, op: str = "sum", bucketed: bool = True) -> Callable:
    """Aggregator over a serving :class:`~repro_torch.serving.registry.MatrixPlan`.

    The served path for resident graphs: admit the (normalized) adjacency
    to a :class:`~repro_torch.serving.registry.MatrixRegistry` once —
    content hashing and the autotune cache make re-admission free — and
    every GNN layer call reuses its device tiles, autotuned geometry and
    strategy.  ``op`` follows :data:`AGGREGATIONS`; mean uses the
    in-degree the plan captured at admission.  Like
    :func:`make_aggregator` it is not differentiable on the kernel
    strategies; train through :func:`plan_diff_aggregator`.
    """
    _check_op(op)
    return lambda x: plan.aggregate(x, op=op, bucketed=bucketed)


def plan_diff_aggregator(plan, *, op: str = "sum", mode: str = "vjp") -> Callable:
    """Differentiable aggregator over a registry-resident plan pair.

    The training-side sibling of :func:`plan_aggregator`: admit the
    adjacency with :meth:`~repro_torch.serving.registry.MatrixRegistry.
    admit_pair` (A and Aᵀ built together, linked by content hash) and the
    closure's backward launches the linked transpose plan's tiles.  Mean
    uses the in-degree the plan captured at admission.
    """
    _check_op(op)
    return plan.diff_aggregator(op=op, mode=mode)


def make_attention_aggregator(
    adj: CSRMatrix, *, strategy: Optional[str] = None, device=None
) -> Callable:
    """GAT's differentiable attention aggregation over ``adj`` (row =
    destination; GAT's convention is ``A + I``), tiled here with its
    transpose (:func:`repro_torch.kernels.autodiff.hbp_transpose`) and
    staged on ``device`` with the slot maps: ``agg(z, s_src, s_dst)``, see
    :func:`repro_torch.kernels.autodiff.attention_aggregator`.  For served
    graphs prefer the registry pair's
    :meth:`~repro_torch.serving.registry.MatrixPlan.attention_aggregator`."""
    pair = autodiff.hbp_transpose(adj)
    dev = ops.resolve_device(device)
    strategy = _strategy(strategy, dev)
    ops.check_strategy(strategy)

    def stage(tiles):
        meta = dict(n_rowgroups=tiles.n_rowgroups, n_rows=tiles.shape[0],
                    col_block=tiles.cfg.col_block, strategy=strategy)
        return ops.device_tiles(tiles, dev), meta

    (dt, meta), (dt_T, meta_T) = stage(pair.tiles), stage(pair.tiles_T)
    maps = autodiff.attention_maps(adj, pair.tiles, pair.tiles_T, dev)
    return autodiff.attention_aggregator(dt, dt_T, maps, meta, meta_T)

