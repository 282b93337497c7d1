"""Metrics core: counters, gauges, histograms, series, and their registry.

The paper's whole argument is a cost ledger — preprocessing time against
SpMV speedup — and this module is where the ledger lives at runtime.
Metrics are plain thread-safe objects that always work when held directly
(the serving registry/engine use them as the backing store for their
``stats()`` views, enabled or not); the *gated* convenience constructors in
:mod:`repro.obs` return a shared no-op when observability is disabled, so
hot-path instrumentation costs one global read and nothing else.

Types:

* :class:`Counter` — monotone float/int accumulator (``inc``);
* :class:`Gauge` — last-write-wins level (``set``/``inc``/``dec``);
* :class:`Histogram` — fixed log-spaced buckets plus an optional sliding
  window of raw samples: percentiles are *exact* over the window while it
  covers every observation (the serving latency contract inherited from
  the pre-obs engine) and bucket-interpolated beyond it;
* :class:`Series` — an append-only (index, value) stream for quantities
  that are ordered but not timestamped, e.g. per-iteration solver
  residuals recorded post-hoc from a ``lax.while_loop`` carry.

Every :class:`MetricRegistry` self-registers in a process-global weak set
so ``repro.obs.dump()``/``report()`` can aggregate over all live
registries — including the per-``MatrixRegistry`` instances that keep
test runs isolated from each other.
"""
from __future__ import annotations

import math
import threading
import weakref
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Series",
    "MetricRegistry",
    "get_registry",
    "all_registries",
    "default_buckets",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def default_buckets() -> np.ndarray:
    """Log-spaced bucket bounds covering 100 ns .. 100 s at ~12% width.

    20 buckets per decade over 9 decades: wide enough for admission times
    (seconds) and kernel launches (tens of microseconds) in one histogram,
    fine enough that an interpolated percentile lands within ~6% of the
    true value (half a bucket).
    """
    return np.logspace(-7, 2, 181)


class _Metric:
    """Shared identity: ``name`` plus a frozen label set."""

    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()

    def _ident(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels)}


class Counter(_Metric):
    """Monotone accumulator.  ``inc`` is thread-safe (guarded, not GIL-lucky)."""

    __slots__ = ("_value",)

    def __init__(self, name: str, labels: Dict[str, object]):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {**self._ident(), "type": "counter", "value": self._value}


class Gauge(_Metric):
    """Last-write-wins level (queue depths, occupancies, config choices)."""

    __slots__ = ("_value",)

    def __init__(self, name: str, labels: Dict[str, object]):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {**self._ident(), "type": "gauge", "value": self._value}


class Histogram(_Metric):
    """Fixed-bucket histogram with an optional exact sliding window.

    ``buckets`` are the ascending bucket *bounds*; observation ``v`` lands
    in the bucket whose bound is the first one ``>= v`` (underflow goes to
    bucket 0, overflow to the extra last slot).  ``window`` raw samples are
    retained (default 4096, the engine's historical latency window):
    :meth:`percentile` is numpy-exact while the window still holds every
    observation, and falls back to linear interpolation inside the bucket
    bounds once observations have been evicted — bounded error, bounded
    memory, regardless of traffic volume.

    ``observe(v, exemplar=trace_id)`` additionally keeps the **most
    recent exemplar per bucket** (one ``(trace_id, value)`` slot, lazily
    allocated on the first exemplar ever seen), so a p99 outlier bucket
    links straight to the trace that landed in it — the OpenMetrics
    exporter renders them as ``# {trace_id="..."} v`` bucket exemplars.
    """

    __slots__ = (
        "bounds", "bucket_counts", "count", "total", "vmin", "vmax",
        "_window", "_exemplars",
    )

    def __init__(
        self,
        name: str,
        labels: Dict[str, object],
        *,
        buckets: Optional[Iterable[float]] = None,
        window: int = 4096,
    ):
        super().__init__(name, labels)
        self.bounds = np.asarray(
            default_buckets() if buckets is None else list(buckets), np.float64
        )
        if self.bounds.size < 1 or np.any(np.diff(self.bounds) <= 0):
            raise ValueError("histogram buckets must be ascending and non-empty")
        self.bucket_counts = np.zeros(self.bounds.size + 1, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._window = deque(maxlen=window) if window > 0 else None
        self._exemplars: Optional[list] = None  # per-bucket (trace_id, value)

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        idx = int(np.searchsorted(self.bounds, v, side="left"))
        with self._lock:
            self.bucket_counts[idx] += 1
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            if self._window is not None:
                self._window.append(v)
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * (self.bounds.size + 1)
                self._exemplars[idx] = (str(exemplar), v)

    def exemplars(self) -> List[dict]:
        """The retained per-bucket exemplars, ascending by bucket.

        Each entry carries the bucket's upper bound (``math.inf`` for the
        overflow slot), the exemplar's observed value, and its trace id —
        the join key back to flight dumps and flow events.
        """
        with self._lock:
            if self._exemplars is None:
                return []
            kept = list(enumerate(self._exemplars))
        out = []
        for i, ex in kept:
            if ex is None:
                continue
            le = float(self.bounds[i]) if i < self.bounds.size else math.inf
            out.append({"le": le, "trace_id": ex[0], "value": ex[1]})
        return out

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> Optional[float]:
        """Quantile ``q`` in [0, 1]: exact over the sample window while it
        holds every observation, bucket-interpolated otherwise."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            if self._window is not None and len(self._window) == self.count:
                # the exact path reproduces the pre-obs engine convention:
                # sorted[int(q * (n - 1))], no interpolation between samples
                lat = np.sort(np.asarray(self._window, np.float64))
                return float(lat[int(q * (lat.size - 1))])
            counts = self.bucket_counts.copy()
            vmin, vmax, count = self.vmin, self.vmax, self.count
        rank = q * (count - 1)
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c > rank:
                lo = vmin if i == 0 else float(self.bounds[i - 1])
                hi = vmax if i >= self.bounds.size else float(self.bounds[i])
                lo = max(lo, vmin)
                hi = min(hi, vmax)
                frac = (rank - cum) / c
                return float(lo + frac * (hi - lo))
            cum += c
        return float(vmax)

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        snap = {
            **self._ident(),
            "type": "histogram",
            "count": count,
            "sum": total,
            "min": vmin if count else None,
            "max": vmax if count else None,
        }
        for q in (0.50, 0.95, 0.99):
            snap[f"p{int(q * 100)}"] = self.percentile(q)
        ex = self.exemplars()
        if ex:
            snap["exemplars"] = ex
        return snap


class Series(_Metric):
    """Ordered (index, value) stream — iteration-indexed, not timestamped.

    Solver residual histories and training loss curves are produced on
    device inside ``lax.while_loop`` carries and recorded *post-hoc*; the
    index is the iteration number, which is the honest x-axis (inventing
    wall-clock timestamps after the fact would corrupt the trace
    timeline).  The window bounds memory on long runs.
    """

    __slots__ = ("_points", "count")

    def __init__(self, name: str, labels: Dict[str, object], *, window: int = 4096):
        super().__init__(name, labels)
        self._points: deque = deque(maxlen=window)
        self.count = 0

    def append(self, value: float, index: Optional[int] = None) -> None:
        with self._lock:
            idx = self.count if index is None else int(index)
            self._points.append((idx, float(value)))
            self.count += 1

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.append(v)

    @property
    def points(self) -> List[Tuple[int, float]]:
        with self._lock:
            return list(self._points)

    @property
    def values(self) -> List[float]:
        return [v for _, v in self.points]

    def snapshot(self) -> dict:
        pts = self.points
        vals = [v for _, v in pts]
        return {
            **self._ident(),
            "type": "series",
            "count": self.count,
            "first": vals[0] if vals else None,
            "last": vals[-1] if vals else None,
            "min": min(vals) if vals else None,
            "max": max(vals) if vals else None,
            "points": pts,
        }


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram, "series": Series}

# weak set of every live registry, aggregated by repro.obs.dump()/report()
_ALL: "weakref.WeakSet[MetricRegistry]" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()
_UNNAMED = [0]


class MetricRegistry:
    """Get-or-create home for metrics, keyed by (type, name, labels).

    One process-global instance (:func:`get_registry`) backs the gated
    ``repro.obs`` constructors; subsystems that need isolated bookkeeping
    (each serving ``MatrixRegistry`` shares one with its engines) create
    their own — all live instances are visible to :func:`all_registries`.
    """

    def __init__(self, name: Optional[str] = None):
        if name is None:
            with _ALL_LOCK:
                _UNNAMED[0] += 1
                name = f"registry-{_UNNAMED[0]}"
        self.name = name
        self._metrics: Dict[Tuple[str, str, LabelKey], _Metric] = {}
        self._lock = threading.RLock()
        with _ALL_LOCK:
            _ALL.add(self)

    def _get_or_create(self, cls_name: str, name: str, labels: dict, **kwargs):
        key = (cls_name, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                conflict = [k for k in self._metrics if k[1] == name and k[0] != cls_name]
                if conflict:
                    raise TypeError(
                        f"metric {name!r} already registered as {conflict[0][0]}, "
                        f"requested {cls_name}"
                    )
                m = _TYPES[cls_name](name, labels, **kwargs)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create("gauge", name, labels)

    def histogram(
        self,
        name: str,
        *,
        buckets: Optional[Iterable[float]] = None,
        window: int = 4096,
        **labels,
    ) -> Histogram:
        return self._get_or_create(
            "histogram", name, labels, buckets=buckets, window=window
        )

    def series(self, name: str, *, window: int = 4096, **labels) -> Series:
        return self._get_or_create("series", name, labels, window=window)

    def get(self, name: str, **labels) -> Optional[_Metric]:
        """The already-registered metric for (name, labels), else None."""
        lk = _label_key(labels)
        with self._lock:
            for (_, n, k), m in self._metrics.items():
                if n == name and k == lk:
                    return m
        return None

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Counter/gauge value for (name, labels); ``default`` if absent."""
        m = self.get(name, **labels)
        return m.value if m is not None and hasattr(m, "value") else default

    def find(self, name: str) -> List[_Metric]:
        """Every metric registered under ``name``, across label sets."""
        with self._lock:
            return [m for (_, n, _), m in self._metrics.items() if n == name]

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values of one label across a metric name (e.g. every
        ``matrix=`` a serving counter has seen)."""
        out = []
        for m in self.find(name):
            v = m.labels.get(label)
            if v is not None and v not in out:
                out.append(v)
        return out

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def collect(self) -> dict:
        """Snapshot of every metric, ready for JSON.

        Sorted by (name, labels, type) so dumps and dashboards are
        deterministic run-to-run — CI artifacts diff cleanly regardless of
        metric creation order.
        """
        snaps = [m.snapshot() for m in self.metrics()]
        snaps.sort(
            key=lambda s: (s["name"], _label_key(s.get("labels") or {}), s["type"])
        )
        return {"registry": self.name, "metrics": snaps}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_GLOBAL = MetricRegistry(name="global")


def get_registry() -> MetricRegistry:
    """The process-global registry the gated ``repro.obs`` helpers use."""
    return _GLOBAL


def all_registries() -> List[MetricRegistry]:
    """Every live registry (global first), for aggregation in dump/report."""
    with _ALL_LOCK:
        live = list(_ALL)
    live.sort(key=lambda r: (r is not _GLOBAL, r.name))
    return live
