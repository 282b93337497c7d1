"""Measured partition-config search with a persistent on-disk cache.

``tuned_partition_config`` (core/tile.py) picks a lane width from the nnz
profile — a heuristic.  A serving system can afford better: the matrix is
admitted once and then multiplied thousands of times, so a few measured
SpMM launches per candidate geometry are noise against the traffic they
optimise.  :func:`autotune_partition` times every candidate from the
:func:`repro_torch.core.partition.enumerate_configs` search space and
keeps the fastest, caching the winner on disk keyed by the matrix's
content hash so the next admission skips the search entirely.

The default objective is steady-state multiply time (one ``hbp_spmm``
launch at the traffic's typical RHS width); :func:`cg_probe` ranks by a
fixed number of CG iterations instead.  Both are timed with CUDA events
after a warm-up on the card and with the host clock on the CPU.  Every
entry point here measures on the card unless the caller passes
``device="cpu"``, and raises without one.  Entries this package writes
live in their own files (``<hash>.torch.json``) and their search
fingerprints name the framework and device type, so they never satisfy
— or overwrite — entries of another implementation or device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.partition import PartitionConfig, enumerate_configs
from repro_torch.core.tile import build_tiles, tuned_partition_config
from repro_torch.kernels import ops

__all__ = [
    "matrix_hash",
    "AutotuneCache",
    "AutotuneResult",
    "Probe",
    "spmm_probe",
    "cg_probe",
    "autotune_partition",
    "DEFAULT_CACHE_DIR",
]

DEFAULT_CACHE_DIR = ".hbp_autotune"
_CACHE_VERSION = 1
_ENTRY_SUFFIX = ".torch.json"


def matrix_hash(csr: CSRMatrix) -> str:
    """Content hash of a CSR matrix: shape + structure + values.

    Two admissions of the same matrix — different objects, different
    processes, either implementation — hash identically.
    """
    h = hashlib.sha256()
    h.update(np.asarray(csr.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.indptr).tobytes())
    h.update(np.ascontiguousarray(csr.indices).tobytes())
    h.update(np.ascontiguousarray(csr.data, dtype=np.float64).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """Outcome of one :func:`autotune_partition` call."""

    cfg: PartitionConfig
    cache_hit: bool  # config came from the on-disk cache; no search ran
    searched: bool  # a measured search ran this call
    evaluations: int  # candidate geometries actually timed
    objective_us: Optional[float]  # best measured SpMM time (None: heuristic)
    # every candidate measured, ``{"config": {...}, "objective_us": float}``,
    # fastest first — persisted into the cache entry
    trials: tuple = ()


class AutotuneCache:
    """On-disk partition-config cache: one JSON file per matrix hash.

    The directory (default ``.hbp_autotune/``, or ``$HBP_AUTOTUNE_DIR``) is
    safe to persist across runs.  Unreadable or version-mismatched entries
    are treated as misses, never errors.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        if path is None:
            path = os.environ.get("HBP_AUTOTUNE_DIR", DEFAULT_CACHE_DIR)
        self.path = Path(path)

    def _entry(self, key: str) -> Path:
        return self.path / f"{key}{_ENTRY_SUFFIX}"

    def get(self, key: str) -> Optional[dict]:
        try:
            entry = json.loads(self._entry(key).read_text())
        except (OSError, ValueError):
            return None
        if entry.get("version") != _CACHE_VERSION or "config" not in entry:
            return None
        return entry

    def get_config(self, key: str) -> Optional[PartitionConfig]:
        entry = self.get(key)
        if entry is None:
            return None
        try:
            return PartitionConfig(**entry["config"])
        except TypeError:
            return None

    def put(self, key: str, cfg: PartitionConfig, **extra) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        entry = {"version": _CACHE_VERSION, "config": dataclasses.asdict(cfg), **extra}
        # per-process tmp name + atomic rename: concurrent admits of the
        # same matrix each install a complete entry, last writer wins
        tmp = self._entry(key).with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(entry, indent=2, sort_keys=True))
        os.replace(tmp, self._entry(key))


def _space_fingerprint(
    candidates: Sequence[PartitionConfig], k: int, strategy: str, probe: "Probe"
) -> str:
    """Content key of a measured search: the candidate set plus the
    objective that ranked it, including the probe's framework and device
    type — a search on one device never satisfies an admission on
    another."""
    geoms = sorted((c.row_block, c.col_block, c.group, c.lane) for c in candidates)
    key = ("torch", geoms, k, strategy, probe.kind, probe.params)
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Probe:
    """A measured-search objective: what one candidate geometry costs.

    ``measure(csr, cfg, repeats)`` returns the objective in microseconds
    (lower is better); ``kind`` and ``params`` enter the cache
    fingerprint.
    """

    kind: str
    measure: Callable[[CSRMatrix, PartitionConfig, int], float]
    params: tuple = ()

    def __call__(self, csr: CSRMatrix, cfg: PartitionConfig, repeats: int) -> float:
        return self.measure(csr, cfg, repeats)


def spmm_probe(k: int = 8, strategy: str = "stable", device=None) -> Probe:
    """The default serving objective: one steady-state k-wide SpMM launch
    on ``device`` (default: the card) under ``strategy`` (any of
    ``ops.STRATEGIES``, the ``"partials"`` split included).  The device
    type is part of the fingerprint."""
    ops.check_strategy(strategy)
    dev = ops.resolve_device(device)
    return Probe(
        kind="spmm",
        measure=lambda csr, cfg, repeats: _measure_spmm_us(
            csr, cfg, k, repeats, strategy, device=dev
        ),
        params=(k, strategy, dev.type),
    )


def cg_probe(
    iters: int = 10, k: int = 1, strategy: Optional[str] = None, seed: int = 0, device=None
) -> Probe:
    """Solver-objective probe: the time of ``iters`` CG iterations.

    Ranks candidate geometries by what an iterative-solver workload
    actually pays — time to (a proxy for) tolerance rather than raw
    multiply time, folding in the per-iteration vector work and, for
    blocked RHS (``k > 1``), the SpMM amortization the solver sees.
    ``tol=0`` pins the iteration count so every candidate runs exactly
    ``iters`` steps of the same Krylov recurrence.  ``strategy`` defaults
    to what a registry on ``device`` (default: the card) serves
    (:func:`repro_torch.kernels.ops.default_strategy`).  The kind names the
    solve, as in the JAX package; the params name the device type.
    """
    if strategy is not None:
        ops.check_strategy(strategy)
    dev = ops.resolve_device(device)
    if strategy is None:
        strategy = ops.default_strategy(dev)

    def measure(csr: CSRMatrix, cfg: PartitionConfig, repeats: int) -> float:
        from repro_torch.solvers import aslinearoperator, cg

        op = aslinearoperator(build_tiles(csr, cfg), strategy=strategy, device=dev)
        rng = np.random.default_rng(seed)
        shape = (csr.n_rows,) if k == 1 else (csr.n_rows, k)
        b = op.vector(rng.standard_normal(shape).astype(np.float32))
        return _timed_us(dev, lambda: cg(op, b, tol=0.0, maxiter=iters), repeats)

    return Probe(kind=f"cg{iters}x{k}_{strategy}", measure=measure, params=(dev.type,))


def _timed_us(dev: torch.device, fn, repeats: int) -> float:
    """Median microseconds of ``fn()`` over ``repeats`` calls after an
    untimed warm-up call (kernel build and load outside the clock): CUDA
    events around each call on the card, the host clock on the CPU."""
    fn()
    ts = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)  # ms -> us
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def _measure_spmm_us(
    csr: CSRMatrix,
    cfg: PartitionConfig,
    k: int,
    repeats: int,
    strategy: str,
    device=None,
) -> float:
    """Median microseconds of one k-wide SpMM launch under ``cfg`` on
    ``device`` (default: the card), timed by :func:`_timed_us`."""
    dt = ops.device_tiles(build_tiles(csr, cfg), device)
    x = torch.as_tensor(
        np.random.default_rng(0).standard_normal((csr.n_cols, k)).astype(np.float32)
    ).to(dt.device)
    return _timed_us(dt.device, lambda: ops.hbp_spmm(dt, x, strategy=strategy), repeats)


def autotune_partition(
    csr: CSRMatrix,
    *,
    key: Optional[str] = None,
    cache: AutotuneCache | None = None,
    search: bool = True,
    candidates: Optional[Sequence[PartitionConfig]] = None,
    k: int = 8,
    repeats: int = 3,
    strategy: str = "stable",
    probe: Optional[Probe] = None,
    device=None,
) -> AutotuneResult:
    """Pick a :class:`PartitionConfig` for ``csr``, cheapest source first.

    1. on-disk cache hit for the matrix's content hash → no search;
    2. ``search=True`` → time every candidate (``enumerate_configs`` by
       default) on ``device`` (default: the card) and keep the fastest;
    3. ``search=False`` → the ``tuned_partition_config`` nnz-profile
       heuristic.

    The chosen config is written back to the cache.  A heuristic entry
    satisfies only ``search=False`` callers, and a searched entry
    satisfies ``search=True`` callers only when it covered the same
    candidate space under the same objective (probe, width, strategy and
    device type); a mismatched admission re-searches and overwrites.
    """
    device = ops.resolve_device(device)
    cache = cache or AutotuneCache()
    key = key or matrix_hash(csr)
    if probe is None:
        probe = spmm_probe(k=k, strategy=strategy, device=device)
    if search:
        candidates = (
            enumerate_configs(csr.shape) if candidates is None else list(candidates)
        )
    space = _space_fingerprint(candidates, k, strategy, probe) if search else None
    entry = cache.get(key)
    if entry is not None:
        satisfied = (entry.get("searched") and entry.get("space") == space) if search else True
        cached = cache.get_config(key)
        if satisfied and cached is not None:
            return AutotuneResult(
                cfg=cached, cache_hit=True, searched=False, evaluations=0,
                objective_us=entry.get("objective_us"),
                trials=tuple(entry.get("trials") or ()),
            )

    if not search:
        cfg = tuned_partition_config(csr)
        cache.put(key, cfg, searched=False, objective_us=None)
        return AutotuneResult(
            cfg=cfg, cache_hit=False, searched=False, evaluations=0, objective_us=None
        )

    best_cfg, best_us = None, float("inf")
    trials = []
    with obs.span("serve.autotune", probe=probe.kind, candidates=len(candidates)) as search_sp:
        for cand in candidates:
            with obs.span(
                "serve.autotune_trial",
                row_block=cand.row_block,
                col_block=cand.col_block,
                lane=cand.lane,
            ) as sp:
                us = probe(csr, cand, repeats)
                sp.annotate(objective_us=round(us, 1))
            trials.append({"config": dataclasses.asdict(cand), "objective_us": round(us, 1)})
            if us < best_us:
                best_cfg, best_us = cand, us
        search_sp.annotate(best_us=round(best_us, 1))
    trials.sort(key=lambda t: (t["objective_us"], sorted(t["config"].items())))
    if best_cfg is None:  # empty candidate list: fall back to the heuristic
        return autotune_partition(csr, key=key, cache=cache, search=False, device=device)
    from repro_torch.obs.flight import get_flight

    get_flight().record(
        "serve.autotune", probe=probe.kind, candidates=len(candidates),
        best_us=round(best_us, 1),
    )
    cache.put(
        key, best_cfg, searched=True, objective_us=best_us, space=space,
        probe=probe.kind, trials=trials,
    )
    return AutotuneResult(
        cfg=best_cfg,
        cache_hit=False,
        searched=True,
        evaluations=len(candidates),
        objective_us=best_us,
        trials=tuple(trials),
    )
