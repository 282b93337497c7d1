"""Node-classification training loop over differentiable HBP aggregation.

The trainer composes the pieces the rest of the package owns:

* forward — :mod:`repro_torch.graph.layers_gnn` GCN/GraphSAGE/GAT stacks
  over a differentiable aggregator (:mod:`repro_torch.kernels.autodiff`),
  so the gradient of the loss launches the transpose-adjacency SpMM (or
  the argmax scatter, or for GAT the SpMMs on Aᵀ rewritten with the
  attention weights and the SDDMM) instead of recording the kernels;
* optimizer — :func:`repro_torch.optim.adamw.adamw_update` (warmup +
  cosine schedule, global-norm clipping), the JAX package's step written
  out on tensors;
* residency — an optional serving :class:`~repro_torch.serving.registry.
  MatrixRegistry`: adjacencies are admitted as linked (A, Aᵀ) pairs, and
  in mini-batch mode each sampled subgraph is content-hashed, so epochs
  after the first re-admit every batch for free.

Two regimes: :meth:`NodeClassifierTrainer.fit` trains full-graph (one
resident adjacency, every step aggregates all nodes);
:meth:`~NodeClassifierTrainer.fit_sampled` trains GraphSAGE-style
neighbor-sampled mini-batches (:mod:`repro_torch.graph.train.sampling`),
with supervision restricted to each batch's seed nodes.

This is the port of ``repro.graph.train.trainer``: parameters are lists of
:class:`~repro_torch.graph.layers_gnn.DenseParams` /
:class:`~repro_torch.graph.layers_gnn.SageParams` tensors, the state is
functional (each step returns a new :class:`TrainState`), and the same
carried weights, optimizer state and sampler seed give the JAX package's
loss history.  GAT (:class:`~repro_torch.graph.layers_gnn.GATParams`) is
the port's own: the JAX package has none.  Training runs on the card
unless ``device="cpu"`` is passed (or the registry's device is the CPU).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.formats import CSRMatrix
from repro_torch.kernels import ops
from repro_torch.kernels.autodiff import needs_transpose
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    load_opt_state,
    tree_flatten,
)

from ..aggregate import make_attention_aggregator, make_diff_aggregator, plan_diff_aggregator
from ..graph import add_self_loops, normalize_adjacency
from ..layers_gnn import (
    DenseParams,
    GATParams,
    SageParams,
    gat_forward,
    gcn_forward,
    init_gat,
    init_gcn,
    init_sage,
    params_from_arrays,
    sage_forward,
)
from .loss import accuracy, softmax_cross_entropy
from .sampling import sample_neighbors

__all__ = ["TrainState", "NodeClassifierTrainer"]

# the forwards and their adjacency conventions: GCN over Â, SAGE over the
# raw A, GAT over A + I (attention weights written into the tiles each step)
MODELS = ("gcn", "sage", "gat")


class TrainState(NamedTuple):
    """Parameters + optimizer state; advance with ``trainer.step``."""

    params: Any
    opt_state: Dict[str, Any]


class NodeClassifierTrainer:
    """Cross-entropy node classification with GCN, GraphSAGE or GAT.

    ``dims`` is the layer stack ``[n_features, hidden..., n_classes]``.
    ``model`` picks the forward and the adjacency convention: ``"gcn"``
    sum-aggregates over the symmetric-normalized self-loop adjacency,
    ``"sage"`` mean/max-aggregates over the raw adjacency (``op``
    defaults accordingly and must be "sum" | "mean" | "max"), ``"gat"``
    attends over ``A + I`` with ``heads`` heads a layer (hidden widths in
    ``dims`` are the heads' concatenation, the output width each head's;
    ``op`` is "sum": the attention-weighted sum).  Pass a
    ``registry`` to serve aggregation from resident, content-hashed
    (A, Aᵀ) plan pairs — required for mini-batch cache reuse to pay off;
    training then runs on the registry's device with its strategy.
    Without one, ``device`` (default: the card) and ``strategy`` (default:
    the device's, :func:`repro_torch.kernels.ops.default_strategy`) apply.
    """

    def __init__(
        self,
        dims: Sequence[int],
        *,
        model: str = "gcn",
        op: Optional[str] = None,
        adamw: Optional[AdamWConfig] = None,
        registry=None,
        strategy: Optional[str] = None,
        mode: str = "vjp",
        heads: int = 1,
        device=None,
    ):
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r} (expected one of {MODELS})")
        if len(dims) < 2:
            raise ValueError("dims needs at least [n_features, n_classes]")
        self.dims = list(dims)
        self.model = model
        self.op = op or ("mean" if model == "sage" else "sum")
        if model == "gat" and (self.op != "sum" or mode != "vjp"):
            raise ValueError("model 'gat' aggregates with op='sum' in mode='vjp'")
        self.heads = heads
        self.adamw = adamw or AdamWConfig(
            lr_peak=2e-2, warmup_steps=5, decay_steps=500, weight_decay=0.0
        )
        self.registry = registry
        self.device = registry.device if registry is not None else ops.resolve_device(device)
        if strategy is None:
            strategy = ops.default_strategy(self.device)
        ops.check_strategy(strategy)
        self.strategy = strategy
        self.mode = mode

    # --- setup -------------------------------------------------------------

    def _kind(self):
        return {"gcn": DenseParams, "sage": SageParams, "gat": GATParams}[self.model]

    def init(self, generator) -> TrainState:
        """Glorot weights drawn from ``generator`` (a ``torch.Generator``,
        or an int that seeds one on the CPU, so the card and the CPU draw
        the same weights), zero biases, zero moments."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        if self.model == "gat":
            params = init_gat(generator, self.dims, self.heads, device=self.device)
        else:
            init = init_gcn if self.model == "gcn" else init_sage
            params = init(generator, self.dims, device=self.device)
        return TrainState(params=params, opt_state=init_opt_state(params, self.adamw))

    def load_state(self, params: Sequence[tuple], opt_state=None) -> TrainState:
        """A state carried across from the JAX package: ``params`` one tuple
        of arrays per layer in field order (``init_gcn`` / ``init_sage``, or
        :class:`~repro_torch.graph.layers_gnn.GATParams`' fields),
        ``opt_state`` its ``{"m", "v", "step"}`` in numpy
        (:func:`~repro_torch.optim.adamw.load_opt_state`), or ``None`` for
        a fresh one."""
        carried = params_from_arrays(params, self._kind(), device=self.device)
        if opt_state is None:
            return TrainState(carried, init_opt_state(carried, self.adamw))
        return TrainState(carried, load_opt_state(opt_state, device=self.device))

    def prepare_adjacency(self, adj: CSRMatrix) -> CSRMatrix:
        """The model's adjacency convention: Â for GCN, raw for SAGE, A + I
        for GAT (its values unused: the attention weights replace them)."""
        if self.model == "gcn":
            return normalize_adjacency(add_self_loops(adj), "sym")
        if self.model == "gat":
            return add_self_loops(adj)
        return adj

    def aggregator(self, adj: CSRMatrix) -> Callable[[torch.Tensor], torch.Tensor]:
        """Differentiable aggregator over a *prepared* adjacency.

        With a registry the adjacency is admitted as a linked (A, Aᵀ)
        pair — re-admitting the same content (the resident full graph, or
        a repeated sampled batch) is free; without one, tiles are built
        directly per call.  Ops whose backward never launches Aᵀ (max, or
        the jvp mode) admit only the forward direction.  GAT's pair is
        admitted to be rewritten (its slot maps staged), and the aggregator
        takes ``(z, s_src, s_dst)``.
        """
        if self.model == "gat":
            if self.registry is not None:
                return self.registry.admit_pair(adj, rewritable=True).attention_aggregator()
            return make_attention_aggregator(adj, strategy=self.strategy, device=self.device)
        if self.registry is not None:
            if needs_transpose(self.op, self.mode):
                plan = self.registry.admit_pair(adj)
            else:
                plan = self.registry.admit(adj)
            return plan_diff_aggregator(plan, op=self.op, mode=self.mode)
        return make_diff_aggregator(
            adj, op=self.op, strategy=self.strategy, mode=self.mode, device=self.device
        )

    # --- one step ----------------------------------------------------------

    def _forward(self, agg, params, x: torch.Tensor) -> torch.Tensor:
        fwd = {"gcn": gcn_forward, "sage": sage_forward, "gat": gat_forward}[self.model]
        return fwd(agg, params, x)

    def _on_device(self, x, labels, mask):
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        labels = torch.as_tensor(labels).long().to(self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
        return x, labels, mask

    def step(
        self,
        state: TrainState,
        agg: Callable[[torch.Tensor], torch.Tensor],
        x,
        labels,
        mask=None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """One train step: loss + grads (backward = transpose SpMM) + AdamW.

        Spans (profiler ranges while a profiler records): ``train.step``
        around it all, and inside ``train.forward`` (forward and loss),
        ``train.backward``, ``train.adamw`` and ``train.host_read``."""
        with obs.span("train.step"):
            x, labels, mask = self._on_device(x, labels, mask)
            leaves, rebuild = tree_flatten(state.params)
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            with obs.span("train.forward"):
                logits = self._forward(agg, rebuild(leaves), x)
                loss = softmax_cross_entropy(logits, labels, mask)
            with obs.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
            with obs.span("train.adamw"):
                params, opt_state, metrics = adamw_update(
                    rebuild([p.detach() for p in leaves]), rebuild(list(grads)),
                    state.opt_state, self.adamw,
                )
            with obs.span("train.host_read"):
                out = {
                    "loss": float(loss.detach()),
                    "accuracy": float(accuracy(logits.detach(), labels, mask)),
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "step": int(metrics["step"]),
                }
            # one always-on flight instant per step (the values are already
            # host floats); a post-mortem shows training progress around
            # whatever anomaly triggered the dump
            obs.get_flight().record(
                "train.step",
                model=self.model,
                step=out["step"],
                loss=out["loss"],
                grad_norm=out["grad_norm"],
            )
            if obs.enabled():
                i = out["step"]
                obs.series("train.loss", model=self.model).append(out["loss"], index=i)
                obs.series("train.grad_norm", model=self.model).append(out["grad_norm"], index=i)
                obs.series("train.accuracy", model=self.model).append(out["accuracy"], index=i)
                obs.counter("train.steps", model=self.model).inc()
        return TrainState(params, opt_state), out

    def evaluate(self, state: TrainState, agg, x, labels, mask=None) -> Dict[str, float]:
        """Loss and accuracy of ``state`` without a gradient."""
        x, labels, mask = self._on_device(x, labels, mask)
        with torch.no_grad():
            logits = self._forward(agg, state.params, x)
            return {
                "loss": float(softmax_cross_entropy(logits, labels, mask)),
                "accuracy": float(accuracy(logits, labels, mask)),
            }

    # --- training regimes --------------------------------------------------

    def fit(
        self,
        adj: CSRMatrix,
        x,
        labels,
        *,
        steps: int,
        state: Optional[TrainState] = None,
        key: int = 0,
        mask=None,
    ) -> Tuple[TrainState, List[Dict[str, float]]]:
        """Full-graph training: one resident adjacency, ``steps`` updates
        (from ``state``, or from weights seeded by ``key``)."""
        state = state or self.init(key)
        agg = self.aggregator(self.prepare_adjacency(adj))
        x, labels, mask = self._on_device(x, labels, mask)
        history = []
        for _ in range(steps):
            state, metrics = self.step(state, agg, x, labels, mask)
            history.append(metrics)
        return state, history

    def fit_sampled(
        self,
        adj: CSRMatrix,
        x,
        labels,
        *,
        steps: int,
        batch_size: int,
        fanouts: Sequence[int] = (10, 5),
        state: Optional[TrainState] = None,
        key: int = 0,
        seed: int = 0,
        train_nodes=None,
    ) -> Tuple[TrainState, List[Dict[str, float]]]:
        """Neighbor-sampled mini-batch training (GraphSAGE's regime).

        One epoch is a fixed partition of ``train_nodes`` (default: all)
        into ``batch_size`` seed groups; epochs cycle the same batches
        with the same per-batch sampler seeds, so every subgraph after
        the first epoch is a registry content-hash hit (when a registry
        is attached) — per-batch preprocessing is paid once per run.
        Supervision applies to each batch's seed rows only.  The batches
        are drawn with numpy exactly as the JAX package draws them.
        """
        state = state or self.init(key)
        n = adj.shape[0]
        train_nodes = (
            np.arange(n, dtype=np.int64)
            if train_nodes is None
            else np.asarray(train_nodes, dtype=np.int64)
        )
        if train_nodes.size == 0:
            raise ValueError("train_nodes selected no nodes to supervise")
        rng = np.random.default_rng(seed)
        perm = rng.permutation(train_nodes)
        batches = [perm[i : i + batch_size] for i in range(0, perm.size, batch_size)]
        x = torch.as_tensor(x, dtype=torch.float32)
        labels = torch.as_tensor(labels)
        history = []
        for s in range(steps):
            b = s % len(batches)
            batch = sample_neighbors(adj, batches[b], fanouts, seed=seed + b)
            agg = self.aggregator(self.prepare_adjacency(batch.adj))
            nodes = torch.as_tensor(batch.nodes)
            state, metrics = self.step(
                state, agg, x[nodes.to(x.device)], labels[nodes.to(labels.device)],
                batch.seed_mask(),
            )
            metrics["batch_nodes"] = int(batch.nodes.size)
            history.append(metrics)
        return state, history
