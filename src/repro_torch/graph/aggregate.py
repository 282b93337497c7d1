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

The differentiable aggregators (``make_diff_aggregator``,
``plan_diff_aggregator``) belong to the training slice of the port and
raise ``NotImplementedError`` until it lands.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.formats import CSRMatrix
from repro_torch.core.tile import HBPTiles, build_tiles, tuned_partition_config
from repro_torch.kernels import ops

from .graph import degrees

__all__ = [
    "AGGREGATIONS",
    "aggregate",
    "make_aggregator",
    "make_diff_aggregator",
    "mean_divisor",
    "plan_aggregator",
    "plan_diff_aggregator",
]

AGGREGATIONS = ("sum", "mean", "max")

_DEFERRED_DIFF = (
    "differentiable aggregation belongs to the training slice of the port, "
    "not ported yet: ROADMAP queue 1, item 6"
)


def _check_op(op: str) -> None:
    if op not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {op!r} (expected one of {AGGREGATIONS})")


def _strategy(strategy: Optional[str], device: torch.device) -> str:
    if strategy is None:
        return "fused" if device.type == "cuda" else "stable"
    return strategy


def mean_divisor(degree, n_rows: int, device) -> torch.Tensor:
    """``[n, 1]`` clamped in-degree on ``device``: the mean over an empty
    neighborhood is 0."""
    d = torch.as_tensor(degree, dtype=torch.float32).reshape(n_rows, 1)
    return d.clamp(min=1.0).to(device)


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
    tiles).  Every call launches on the staged tiles.
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


def make_diff_aggregator(adj, **kwargs) -> Callable:
    """Differentiable twin of :func:`make_aggregator` — the training
    slice's, not ported yet."""
    raise NotImplementedError(_DEFERRED_DIFF)


def plan_aggregator(plan, *, op: str = "sum", bucketed: bool = True) -> Callable:
    """Aggregator over a serving :class:`~repro_torch.serving.registry.MatrixPlan`.

    The served path for resident graphs: admit the (normalized) adjacency
    to a :class:`~repro_torch.serving.registry.MatrixRegistry` once —
    content hashing and the autotune cache make re-admission free — and
    every GNN layer call reuses its device tiles, autotuned geometry and
    strategy.  ``op`` follows :data:`AGGREGATIONS`; mean uses the
    in-degree the plan captured at admission.
    """
    _check_op(op)
    return lambda x: plan.aggregate(x, op=op, bucketed=bucketed)


def plan_diff_aggregator(plan, *, op: str = "sum", mode: str = "vjp") -> Callable:
    """Differentiable aggregator over a registry plan pair — the training
    slice's, not ported yet."""
    raise NotImplementedError(_DEFERRED_DIFF)
