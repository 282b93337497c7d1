"""GCN and GraphSAGE forward passes over HBP aggregation.

Layers are functions of (aggregator, params, features): the aggregator is
any ``[n, k] -> [n, k]`` callable from
:func:`repro_torch.graph.aggregate.make_aggregator` or
:func:`~repro_torch.graph.aggregate.plan_aggregator`, params are lists of
:class:`DenseParams` / :class:`SageParams` tensors.  :class:`GCN` and
:class:`GraphSAGE` hold such lists as ``nn.Module`` parameters, drawn
from an explicit ``torch.Generator`` or loaded from carried-over weights.

* **GCN** (Kipf & Welling): ``H' = act(Â (H W) + b)`` with
  Â = D^-1/2 (A + I) D^-1/2 — aggregate over
  ``normalize_adjacency(add_self_loops(A), "sym")`` with ``op="sum"``.
  The dense transform runs *before* the sparse aggregation, so the SpMM
  runs at the layer's output width.
* **GraphSAGE** (Hamilton et al.): ``h' = act(x W_self + agg(x) W_neigh
  + b)`` with a mean or max neighbor aggregator over the raw (no
  self-loop) adjacency — max exercises the kernels' max monoid.

The dense transforms are plain ``torch.matmul`` (float32, TF32 off by
PyTorch's default).  Everything takes gradients: the modules' parameters
are trainable, and the functional forwards over parameter lists
differentiate through any aggregator from
:func:`~repro_torch.graph.aggregate.make_diff_aggregator` or
:func:`~repro_torch.graph.aggregate.plan_diff_aggregator` (whose backward
is the transpose SpMM, or the argmax scatter under max).
:func:`params_from_arrays` carries weights in as such lists.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import obs

__all__ = [
    "DenseParams",
    "SageParams",
    "init_gcn",
    "init_sage",
    "gcn_layer",
    "gcn_forward",
    "sage_layer",
    "sage_forward",
    "params_from_arrays",
    "GCN",
    "GraphSAGE",
]

Aggregator = Callable[[torch.Tensor], torch.Tensor]


class DenseParams(NamedTuple):
    """One GCN layer: feature transform W [in, out] and bias b [out]."""

    W: torch.Tensor
    b: torch.Tensor


class SageParams(NamedTuple):
    """One GraphSAGE layer: self and neighbor transforms plus bias."""

    W_self: torch.Tensor  # [in, out]
    W_neigh: torch.Tensor  # [in, out]
    b: torch.Tensor  # [out]


def _glorot(generator: torch.Generator, fan_in: int, fan_out: int, device) -> torch.Tensor:
    scale = float(np.sqrt(2.0 / (fan_in + fan_out)))
    w = torch.randn(
        (fan_in, fan_out), generator=generator, dtype=torch.float32, device=generator.device
    )
    return (scale * w).to(device)


def init_gcn(generator: torch.Generator, dims: Sequence[int], device=None) -> List[DenseParams]:
    """Glorot-initialized GCN stack: dims = [in, hidden..., out]."""
    return [
        DenseParams(
            W=_glorot(generator, d_in, d_out, device),
            b=torch.zeros(d_out, dtype=torch.float32, device=device),
        )
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]


def init_sage(generator: torch.Generator, dims: Sequence[int], device=None) -> List[SageParams]:
    """Glorot-initialized GraphSAGE stack: dims = [in, hidden..., out]."""
    return [
        SageParams(
            W_self=_glorot(generator, d_in, d_out, device),
            W_neigh=_glorot(generator, d_in, d_out, device),
            b=torch.zeros(d_out, dtype=torch.float32, device=device),
        )
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]


def gcn_layer(agg: Aggregator, p: DenseParams, x: torch.Tensor, activation=torch.relu):
    """act(Â (x W) + b); pass ``activation=None`` for the logits layer."""
    h = agg(x @ p.W) + p.b
    return activation(h) if activation is not None else h


def gcn_forward(
    agg: Aggregator, params: Sequence[DenseParams], x: torch.Tensor, *, activation=torch.relu
) -> torch.Tensor:
    """Full GCN forward: activation between layers, raw logits out (span
    ``gnn.forward``)."""
    with obs.span("gnn.forward"):
        for p in params[:-1]:
            x = gcn_layer(agg, p, x, activation)
        return gcn_layer(agg, params[-1], x, activation=None)


def sage_layer(agg: Aggregator, p: SageParams, x: torch.Tensor, activation=torch.relu):
    """act(x W_self + agg(x) W_neigh + b): ``agg`` supplies the aggregation
    semantics (mean or max), the layer itself is aggregation-agnostic."""
    h = x @ p.W_self + agg(x) @ p.W_neigh + p.b
    return activation(h) if activation is not None else h


def sage_forward(
    agg: Aggregator, params: Sequence[SageParams], x: torch.Tensor, *, activation=torch.relu
) -> torch.Tensor:
    """Full GraphSAGE forward: activation between layers, raw logits out
    (span ``gnn.forward``)."""
    with obs.span("gnn.forward"):
        for p in params[:-1]:
            x = sage_layer(agg, p, x, activation)
        return sage_layer(agg, params[-1], x, activation=None)


def params_from_arrays(params: Sequence[tuple], kind, device=None) -> list:
    """Carried-over weights as a parameter list: one tuple per layer in the
    field order of ``kind`` (:class:`DenseParams` or :class:`SageParams`),
    for example the JAX package's ``init_gcn`` / ``init_sage`` lists with
    each field converted by ``np.asarray``; float32 tensors on ``device``.
    """
    out = []
    for p in params:
        if len(p) != len(kind._fields):
            raise ValueError(f"expected fields {kind._fields}, got {len(p)} arrays")
        out.append(kind(*(
            torch.as_tensor(np.array(v, dtype=np.float32), device=device) for v in p)))
    return out


class _Stack(nn.Module):
    """A stack of layers whose parameters are the fields of ``_PARAMS``."""

    _PARAMS: type = DenseParams

    def __init__(self, params: Sequence[tuple]):
        super().__init__()
        self.layers = nn.ModuleList()
        for p in params:
            layer = nn.Module()
            for field, value in zip(self._PARAMS._fields, p):
                setattr(layer, field, nn.Parameter(value))
            self.layers.append(layer)

    def params(self) -> list:
        """The layers' parameters as a list of ``_PARAMS`` tuples."""
        return [
            self._PARAMS(*(getattr(layer, f) for f in self._PARAMS._fields))
            for layer in self.layers
        ]

    @torch.no_grad()
    def load_params(self, params: Sequence[tuple]) -> None:
        """Copy carried-over weights into the layers.

        ``params`` is one tuple per layer in the field order of
        ``_PARAMS`` — for example the JAX package's ``init_gcn`` /
        ``init_sage`` lists with each field converted by ``np.asarray``.
        Shapes must match the module's.
        """
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} layers of weights for {len(self.layers)} layers")
        for layer, p in zip(self.layers, params):
            if len(p) != len(self._PARAMS._fields):
                raise ValueError(f"expected fields {self._PARAMS._fields}, got {len(p)} arrays")
            for field, value in zip(self._PARAMS._fields, p):
                dst = getattr(layer, field)
                src = torch.from_numpy(np.array(value, dtype=np.float32))
                if src.shape != dst.shape:
                    raise ValueError(
                        f"{field}: carried shape {tuple(src.shape)} != {tuple(dst.shape)}"
                    )
                dst.copy_(src)

    @classmethod
    def from_params(cls, params: Sequence[tuple], device=None):
        """A module holding carried-over weights (see :meth:`load_params`);
        the initial draw it replaces comes from a fixed-seed generator."""
        first = np.asarray(params[0][0])
        dims = [first.shape[0]] + [np.asarray(p[-1]).shape[0] for p in params]
        module = cls(dims, generator=torch.Generator().manual_seed(0), device=device)
        module.load_params(params)
        return module


class GCN(_Stack):
    """GCN as an ``nn.Module``: ``model(agg, x)`` is :func:`gcn_forward`.

    ``GCN(dims, generator=g)`` draws Glorot weights from ``g`` (zero
    biases); :meth:`from_params` / :meth:`load_params` carry weights in.
    """

    _PARAMS = DenseParams

    def __init__(self, dims: Sequence[int], *, generator: torch.Generator, device=None):
        super().__init__(init_gcn(generator, dims, device=device))

    def forward(self, agg: Aggregator, x: torch.Tensor, *, activation=torch.relu):
        return gcn_forward(agg, self.params(), x, activation=activation)


class GraphSAGE(_Stack):
    """GraphSAGE as an ``nn.Module``: ``model(agg, x)`` is :func:`sage_forward`.

    ``GraphSAGE(dims, generator=g)`` draws Glorot weights from ``g`` (zero
    biases); :meth:`from_params` / :meth:`load_params` carry weights in.
    """

    _PARAMS = SageParams

    def __init__(self, dims: Sequence[int], *, generator: torch.Generator, device=None):
        super().__init__(init_sage(generator, dims, device=device))

    def forward(self, agg: Aggregator, x: torch.Tensor, *, activation=torch.relu):
        return sage_forward(agg, self.params(), x, activation=activation)
