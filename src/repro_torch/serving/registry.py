"""Matrix admission: CSR in, device-resident autotuned HBP plan out.

A serving system's defining asymmetry is admit-once / multiply-many: the
HBP preprocessing pipeline (2D partition → nonlinear hash → tile packing)
runs once per matrix, and every subsequent request reuses the device-
resident tiles.  :class:`MatrixRegistry` owns that lifecycle:

* **content addressing** — matrices are keyed by a sha256 over shape +
  structure + values, so re-admitting an already-resident matrix returns
  the existing plan without touching the preprocessing pipeline;
* **autotuned geometry** — the partition config comes from
  :func:`repro_torch.serving.autotune.autotune_partition` (measured search
  with a persistent on-disk cache), unless the caller pins a config;
* **device residency** — tiles are staged to the device once at admission
  (:func:`repro_torch.kernels.ops.device_tiles`); requests only launch
  kernels;
* **amortization bookkeeping** — the one-time preprocessing cost is
  recorded so :meth:`MatrixRegistry.stats` can report how far traffic has
  amortized it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.partition import PartitionConfig
from repro_torch.core.tile import HBPTiles, build_tiles
from repro_torch.kernels import autodiff, ops
from repro_torch.kernels.autodiff import mean_divisor
from repro_torch.obs import planview
from repro_torch.obs.flight import get_flight
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.requesttrace import mint_trace_id

from .autotune import AutotuneCache, autotune_partition, matrix_hash, measure_k_tilings
from .eviction import LRUEvictor, plan_device_bytes

__all__ = ["MatrixPlan", "MatrixRegistry"]

@dataclasses.dataclass
class MatrixPlan:
    """Everything the serving path needs about one resident matrix."""

    name: str
    matrix_hash: str
    shape: tuple
    nnz: int
    cfg: PartitionConfig
    tiles: HBPTiles  # host copy (restaging after eviction, debugging)
    device: object  # staged DeviceTiles (None while budget-evicted)
    diag: np.ndarray  # main diagonal, host-resident at tile-build time
    row_nnz: np.ndarray  # per-row stored-entry count (graph in-degree)
    preprocess_s: float  # autotune + tile build + device staging
    autotune_cache_hit: bool
    autotune_searched: bool
    strategy: str = "fused"
    # wide-k launch contract: "grid" = one launch for any k, "loop" = a
    # host loop of 128-wide launches (an "auto" admission resolves to
    # whichever measured faster)
    k_tiling: str = "grid"
    # admission-time partition-quality metrics and autotune provenance;
    # deliberately NOT part of ``_meta()``: the kernels never see them
    quality: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    provenance: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    # A <-> Aᵀ link, set by MatrixRegistry.admit_pair: the transpose plan's
    # name and the plan itself (a symmetric matrix links to itself: one
    # residency serves both directions)
    transpose_name: Optional[str] = None
    _transpose: object = dataclasses.field(default=None, repr=False, compare=False)
    # the slot maps of a pair admitted to be rewritten
    # (admit_pair(..., rewritable=True)): kernels.autodiff.AttentionMaps on
    # the plan's device, held by the forward plan
    _attention: object = dataclasses.field(default=None, repr=False, compare=False)
    # clamped in-degree [n, 1] on the plan's device, staged on the first
    # mean aggregation (and dropped with the tiles when budget-unstaged)
    _mean_div: object = dataclasses.field(default=None, repr=False, compare=False)
    # the owning registry's shared MetricRegistry — single source of truth
    # for the admission counters this plan's views read
    _metrics: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def admissions(self) -> int:
        """admit() calls that resolved to this plan — a *view* over the
        owning registry's shared metrics, not a second ledger."""
        if self._metrics is None:
            return 1
        return int(self._metrics.value("registry.admissions", 1, matrix=self.name))

    def _meta(self) -> dict:
        return dict(
            n_rowgroups=self.tiles.n_rowgroups,
            n_rows=self.shape[0],
            col_block=self.cfg.col_block,
            strategy=self.strategy,
            k_tiling=self.k_tiling,
        )

    def matvec(self, x):
        """One-off ``A @ x`` against the resident plan (bypasses batching);
        a tensor on the plan's device."""
        return ops.hbp_spmv(self.device, x, **self._meta())

    def matmat(self, x, *, bucketed: bool = True, buckets=None, combine: str = "sum"):
        """``A @ X`` for an ``[n, k]`` block; ``bucketed`` pads k to the
        serving buckets (``buckets`` overrides the default set).
        ``combine`` selects the reduction monoid ("sum" | "max")."""
        if not bucketed:
            return ops.hbp_spmm(self.device, x, combine=combine, **self._meta())
        if buckets is None:
            buckets = ops.K_BUCKETS
        return ops.hbp_spmm_bucketed(
            self.device, x, buckets=buckets, combine=combine, **self._meta()
        )

    def aggregate(self, x, *, op: str = "sum", bucketed: bool = True):
        """Neighborhood aggregation over the resident plan: the matrix read
        as a graph adjacency (rows aggregate their stored neighbors).

        ``op`` is "sum", "mean" (the sum divided by the in-degree captured
        at admission, clamped to 1 so an isolated node aggregates to 0) or
        "max" (the max monoid; 0 for isolated nodes).  Every GNN layer call
        reuses the device tiles and the autotuned geometry.
        """
        with obs.span("agg.forward"):
            if op == "sum":
                return self.matmat(x, bucketed=bucketed)
            if op == "mean":
                if self._mean_div is None:  # staged once, like the tiles
                    self._mean_div = mean_divisor(self.row_nnz, self.shape[0],
                                                  self.device.device)
                return self.matmat(x, bucketed=bucketed) / self._mean_div
            if op == "max":
                return self.matmat(x, bucketed=bucketed, combine="max")
        raise ValueError(f"unknown aggregation {op!r} (sum | mean | max)")

    def diff_aggregator(self, *, op: str = "sum", mode: str = "vjp"):
        """Differentiable aggregation closure over the resident plan.

        The sum and mean backward launches the *linked transpose plan's*
        tiles (``x̄ = Aᵀ @ ȳ``), so the plan must have been admitted with
        :meth:`MatrixRegistry.admit_pair`; max routes cotangents through
        the argmax indices its forward saves and needs no transpose.  Mean
        divides by the in-degree captured at admission.
        """
        if autodiff.needs_transpose(op, mode) and self._transpose is None:
            raise ValueError(
                f"plan {self.name!r} has no linked transpose — admit the "
                "matrix with MatrixRegistry.admit_pair() for differentiable "
                "sum/mean aggregation"
            )
        plan_T = self._transpose
        return autodiff.device_diff_aggregator(
            self.device,
            plan_T.device if plan_T is not None else None,
            self._meta(),
            plan_T._meta() if plan_T is not None else None,
            op=op,
            degree=self.row_nnz if op == "mean" else None,
            mode=mode,
        )

    def attention_aggregator(self):
        """GAT's differentiable attention aggregation over the resident
        pair (:func:`repro_torch.kernels.autodiff.attention_aggregator`):
        each call writes its attention weights into copies of A's tile
        values, its backward into copies of Aᵀ's.  Needs the slot maps
        that :meth:`MatrixRegistry.admit_pair` stages with
        ``rewritable=True``."""
        if self._attention is None:
            raise ValueError(
                f"plan {self.name!r} has no slot maps: admit the matrix with "
                "MatrixRegistry.admit_pair(..., rewritable=True)"
            )
        plan_T = self._transpose
        return autodiff.attention_aggregator(
            self.device, plan_T.device, self._attention, self._meta(), plan_T._meta()
        )

    def operator(self):
        """The plan as a solver-ready :class:`LinearOperator` on the plan's
        device: every application is one launch on the resident tiles
        (``matmat`` bucketed, as served)."""
        from repro_torch.solvers.operator import LinearOperator

        return LinearOperator(self.shape, matvec=self.matvec, matmat=self.matmat,
                              device=self._staged().device)

    def jacobi(self):
        """Jacobi preconditioner from the admission-time diagonal, on the
        plan's device."""
        from repro_torch.solvers.precond import jacobi

        return jacobi(self.diag, device=self._staged().device)

    def _staged(self):
        if self.device is None:
            raise RuntimeError(
                f"plan {self.name!r} is unstaged (evicted under the HBM budget); "
                "get it again through MatrixRegistry.get()"
            )
        return self.device


class MatrixRegistry:
    """Admit CSR matrices once; hand out device-resident HBP plans.

    ``device`` is where plans are staged and served: ``None`` means the
    card, and with no card present the constructor raises (pass
    ``device="cpu"`` to serve with the plain PyTorch versions).  The
    default ``strategy`` follows the device: the fused CUDA kernels on a
    card, the batch-width-invariant ``"stable"`` chain on the CPU;
    ``strategy="partials"`` serves the paper's two-phase split (the
    partials CUDA kernels and a deterministic run combine).

    ``search=False`` replaces the measured autotune search with the
    ``tuned_partition_config`` heuristic (still cached); ``candidates``
    narrows the measured search space.

    ``k_tiling`` selects the wide-k launch contract every plan serves:
    ``"grid"`` (default), ``"loop"``, or ``"auto"`` (measured per matrix
    at admission by :func:`repro_torch.serving.autotune.measure_k_tilings`).

    ``metrics`` is the shared :class:`~repro_torch.obs.metrics.MetricRegistry`
    backing this registry's admission counters *and* every
    :class:`~repro_torch.serving.engine.ServingEngine` built over it.

    ``hbm_budget_bytes`` caps the device footprint of staged tiles: past
    the budget the least-recently-used plans are *unstaged* (device
    tensors dropped, host tiles and geometry kept) and the next
    :meth:`get` transparently re-stages them; transpose pairs from
    :meth:`admit_pair` are unstaged and re-staged as one unit.  ``None``
    disables it.
    """

    def __init__(
        self,
        *,
        device=None,
        cache_dir=None,
        search: bool = True,
        candidates=None,
        autotune_k: int = 8,
        strategy: Optional[str] = None,
        k_tiling: str = "grid",
        probe=None,
        metrics: Optional[MetricRegistry] = None,
        hbm_budget_bytes: Optional[int] = None,
    ):
        self.device = ops.resolve_device(device)
        if strategy is None:
            strategy = "fused" if self.device.type == "cuda" else "stable"
        ops.check_strategy(strategy)
        if k_tiling not in ("grid", "loop", "auto"):
            raise ValueError(f"unknown k_tiling {k_tiling!r} (expected grid, loop or auto)")
        self.cache = AutotuneCache(cache_dir)
        self.search = search
        self.candidates = candidates
        self.autotune_k = autotune_k
        self.strategy = strategy
        self.k_tiling = k_tiling
        self.probe = probe  # None: steady-state SpMM time (spmm_probe)
        self.metrics = metrics if metrics is not None else MetricRegistry(name="serving")
        self.evictor = LRUEvictor(hbm_budget_bytes) if hbm_budget_bytes is not None else None
        self._plans: Dict[str, MatrixPlan] = {}
        self._by_hash: Dict[str, str] = {}

    def admit(
        self,
        csr: CSRMatrix,
        name: Optional[str] = None,
        *,
        cfg: Optional[PartitionConfig] = None,
    ) -> MatrixPlan:
        """Admit ``csr`` and return its plan.

        Same content twice → the resident plan (no rebuild, no search).
        Fresh content with a warm on-disk cache → tile build only.
        ``cfg`` pins the geometry and bypasses autotuning altogether.
        """
        key = matrix_hash(csr)
        if key in self._by_hash:
            plan = self._plans[self._by_hash[key]]
            if cfg is not None and cfg != plan.cfg:
                raise ValueError(
                    f"matrix {key[:12]} is already resident as {plan.name!r} "
                    f"with config {plan.cfg}; re-admission pinned {cfg} — "
                    "evict the plan first to rebuild under a different geometry"
                )
            self.metrics.counter("registry.hits", matrix=plan.name).inc()
            self.metrics.counter("registry.admissions", matrix=plan.name).inc()
            self._ensure_staged(plan)
            return plan
        if name is not None and name in self._plans:
            raise ValueError(
                f"name {name!r} is already bound to matrix "
                f"{self._plans[name].matrix_hash[:12]}"
            )

        admit_id = mint_trace_id("a")
        with obs.span("serve.admit", matrix=name, nnz=csr.nnz, trace_id=admit_id) as sp:
            t0 = time.perf_counter()
            served_tiling = self.k_tiling if self.k_tiling != "auto" else "grid"
            pinned = cfg is not None
            if pinned:
                tune_hit, tune_searched = False, False
                trials, evaluations, objective_us = (), 0, None
            else:
                tuned = autotune_partition(
                    csr,
                    key=key,
                    cache=self.cache,
                    search=self.search,
                    candidates=self.candidates,
                    k=self.autotune_k,
                    strategy=self.strategy,  # rank configs under the served path
                    k_tiling=served_tiling,
                    probe=self.probe,
                    device=self.device,
                )
                cfg = tuned.cfg
                tune_hit, tune_searched = tuned.cache_hit, tuned.searched
                trials = tuned.trials
                evaluations, objective_us = tuned.evaluations, tuned.objective_us
            k_tiling_us = None
            if self.k_tiling == "auto":
                k_tiling_us = measure_k_tilings(
                    csr, cfg, strategy=self.strategy, device=self.device
                )
                if k_tiling_us:
                    served_tiling = min(k_tiling_us, key=k_tiling_us.get)
            tiles = build_tiles(csr, cfg)
            with obs.span("serve.stage_device", matrix=name):
                device = ops.device_tiles(tiles, self.device)
            diag = csr.diagonal()
            row_nnz = csr.row_nnz().astype(np.int64)
            preprocess_s = time.perf_counter() - t0
            name = name or f"m_{key[:12]}"
            sp.annotate(matrix=name, preprocess_s=round(preprocess_s, 6))
            # partition-quality introspection describes the plan; it runs
            # after the preprocess clock stops
            with obs.span("admit.plan_quality", matrix=name, tiles=tiles.n_tiles):
                quality = planview.partition_quality(tiles, csr)
        provenance = {
            "searched": tune_searched,
            "cache_hit": tune_hit,
            "pinned": pinned,
            "evaluations": evaluations,
            "objective_us": objective_us,
            "trials": [dict(t) for t in trials],
            "k_tiling": served_tiling,
            "k_tiling_mode": self.k_tiling,
            "k_tiling_us": k_tiling_us,
        }

        plan = MatrixPlan(
            name=name,
            matrix_hash=key,
            shape=csr.shape,
            nnz=csr.nnz,
            cfg=cfg,
            tiles=tiles,
            device=device,
            diag=diag,
            row_nnz=row_nnz,
            preprocess_s=preprocess_s,
            autotune_cache_hit=tune_hit,
            autotune_searched=tune_searched,
            strategy=self.strategy,
            k_tiling=served_tiling,
            quality=quality,
            provenance=provenance,
            _metrics=self.metrics,
        )
        self._plans[name] = plan
        self._by_hash[key] = name
        m = self.metrics
        planview.register_plan_metrics(m, name, quality, provenance)
        m.counter("registry.misses", matrix=name).inc()
        m.counter("registry.admissions", matrix=name).inc()
        m.counter("registry.preprocess_s", matrix=name).inc(preprocess_s)
        if tune_hit:
            m.counter("registry.autotune_cache_hits", matrix=name).inc()
        if tune_searched:
            m.counter("registry.autotune_searches", matrix=name).inc()
        m.gauge("registry.resident").set(len(self._plans))
        get_flight().record(
            "serve.admit",
            matrix=name,
            nnz=csr.nnz,
            preprocess_s=round(preprocess_s, 6),
            k_tiling=served_tiling,
            trace_id=admit_id,
        )
        self._charge(plan)
        return plan

    def admit_pair(
        self,
        csr: CSRMatrix,
        name: Optional[str] = None,
        *,
        cfg: Optional[PartitionConfig] = None,
        cfg_T: Optional[PartitionConfig] = None,
        rewritable: bool = False,
    ) -> MatrixPlan:
        """Admit ``csr`` AND its transpose, linked for differentiable use.

        The backward of ``A @ X`` is an SpMM against ``Aᵀ``
        (:mod:`repro_torch.kernels.autodiff`), so both directions become
        resident plans cross-linked through ``transpose_name``.  Content
        hashing makes every re-admission free, and a *symmetric* matrix
        (GCN's normalized adjacency) hashes like its transpose: one plan
        serves both directions, with no second build.  Returns the forward
        plan; reach the transpose with :meth:`transpose_of`.  Under an HBM
        budget the pair is evicted and re-staged as one unit.

        ``rewritable=True`` also stages, once, the slot maps that write new
        values into copies of both sides' tile values (each entry of A's
        slot in A's tiles and in Aᵀ's), for
        :meth:`MatrixPlan.attention_aggregator`; other pairs stage none.
        Once staged, the tiles' host ``slot`` arrays are dropped.
        """
        plan = self.admit(csr, name, cfg=cfg)
        if plan._transpose is not None:  # pair already linked (re-admission)
            partner = plan._transpose
            if cfg_T is not None and cfg_T != partner.cfg:
                raise ValueError(
                    f"transpose of {plan.name!r} is already resident as "
                    f"{partner.name!r} with config {partner.cfg}; re-admission "
                    f"pinned {cfg_T} — evict the pair first to rebuild"
                )
            if partner is not plan:  # keep both sides' admission counts in step
                self.metrics.counter("registry.admissions", matrix=partner.name).inc()
        else:
            plan_T = self.admit(csr.transpose(), f"{plan.name}::T", cfg=cfg_T)
            plan.transpose_name = plan_T.name
            plan._transpose = plan_T
            plan_T.transpose_name = plan.name
            plan_T._transpose = plan
            if self.evictor is not None and plan_T is not plan:
                # forward and backward are one residency unit: evicting one
                # side would re-stage it on the next training step
                self.evictor.link(plan.name, plan_T.name)
                # admitting Aᵀ may have unstaged A before the link pinned the
                # pair: stage the whole unit now
                self._ensure_staged(plan)
        if rewritable and plan._attention is None:
            with obs.span("admit.slot_maps", matrix=plan.name):
                plan._attention = autodiff.attention_maps(
                    csr, plan.tiles, plan._transpose.tiles, self.device)
            # staged: the host copies (i64[nnz] a side) serve nothing more
            plan.tiles.slot = plan._transpose.tiles.slot = None
        return plan

    def transpose_of(self, plan: MatrixPlan) -> MatrixPlan:
        """The linked Aᵀ plan (admit with :meth:`admit_pair` first)."""
        if plan._transpose is None:
            raise KeyError(f"plan {plan.name!r} has no linked transpose")
        return plan._transpose

    def get(self, name: str) -> MatrixPlan:
        """The resident plan for ``name`` (raises ``KeyError`` if absent).

        Under an HBM budget this is also the re-admission path: an
        unstaged plan is transparently re-staged here.
        """
        plan = self._plans[name]
        self._ensure_staged(plan)
        return plan

    def __contains__(self, name: str) -> bool:
        return name in self._plans

    def __len__(self) -> int:
        return len(self._plans)

    def names(self):
        """Names of every resident plan (staged or budget-unstaged)."""
        return list(self._plans)

    def evict(self, name: str) -> None:
        """Fully remove ``name``: plan, content-hash binding and pair link."""
        plan = self._plans.pop(name)
        del self._by_hash[plan.matrix_hash]
        partner = plan._transpose
        if partner is not None and partner is not plan:
            partner.transpose_name = None
            partner._transpose = None
        if self.evictor is not None:
            self.evictor.drop(name)
            self.evictor.unlink(name)
        self.metrics.counter("registry.evictions", matrix=name).inc()
        self.metrics.gauge("registry.resident").set(len(self._plans))

    # --- HBM-budget residency ---------------------------------------------

    def _charge(self, plan: MatrixPlan) -> None:
        """Charge ``plan``'s device bytes to the budget; unstage victims."""
        if self.evictor is None:
            return
        victims = self.evictor.admit(plan.name, plan_device_bytes(plan.device))
        for victim in victims:
            self._unstage(victim)
        self.metrics.gauge("evict.resident_bytes").set(self.evictor.resident_bytes)

    def _unstage(self, name: str) -> None:
        """Drop ``name``'s device tensors (host tiles and geometry stay)."""
        plan = self._plans.get(name)
        if plan is None or plan.device is None:
            return
        plan.device = None
        plan._mean_div = None  # staged alongside the tiles; rebuilt on demand
        self.metrics.counter("evict.unstaged", matrix=name).inc()
        get_flight().record("evict.unstage", matrix=name)
        if obs.enabled():
            obs.counter("evict.unstaged", matrix=name).inc()

    def _ensure_staged(self, plan: MatrixPlan) -> None:
        """Refresh recency; re-stage the plan's unit if budget-evicted.

        A transpose pair is one unit: both sides are re-staged together,
        so a training step never finds half of its residency missing."""
        if self.evictor is None:
            return
        self.evictor.touch(plan.name)
        unit = [plan]
        if plan._transpose is not None and plan._transpose is not plan:
            unit.append(plan._transpose)
        for p in unit:
            if p.device is not None:
                continue
            t0 = time.perf_counter()
            with obs.span("serve.restage", matrix=p.name):
                p.device = ops.device_tiles(p.tiles, self.device)
            restage_s = time.perf_counter() - t0
            m = self.metrics
            m.counter("evict.restages", matrix=p.name).inc()
            m.counter("evict.restage_s", matrix=p.name).inc(restage_s)
            get_flight().record("evict.restage", matrix=p.name, restage_s=round(restage_s, 6))
            self._charge(p)

    def stats(self) -> dict:
        """Per-matrix admission/preprocessing snapshot (engine adds traffic).

        A *view*: admission counts are read back from the shared
        :class:`~repro_torch.obs.metrics.MetricRegistry` (``self.metrics``).
        """
        return {
            name: {
                "matrix_hash": p.matrix_hash[:12],
                "shape": tuple(p.shape),
                "nnz": p.nnz,
                "config": dataclasses.asdict(p.cfg),
                "k_tiling": p.k_tiling,
                "admissions": p.admissions,
                "preprocess_s": p.preprocess_s,
                "autotune_cache_hit": p.autotune_cache_hit,
                "autotune_searched": p.autotune_searched,
                "quality": {k: v for k, v in p.quality.items() if k != "occupancy_sample"},
                "provenance": p.provenance,
            }
            for name, p in self._plans.items()
        }
