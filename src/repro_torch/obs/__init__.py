"""Observability for the PyTorch port: spans, metrics, flight recorder.

The port's own copy of the gated telemetry facade: admission stages, the
serving hot loop and kernel launches report through this one surface.
The OpenMetrics exporter and the text dashboard are not part of it yet.

**Off by default.**  ``enable()`` (or ``REPRO_OBS=1`` in the environment)
turns it on; while disabled, :func:`span`, :func:`counter`,
:func:`gauge`, :func:`histogram` and :func:`series` all return one shared
no-op object whose methods do nothing — a hot call site pays a module
attribute read and a falsy check, nothing allocates, nothing locks.
Call sites that want even that gone guard with ``if obs.enabled():``.

Two kinds of state:

* **gated instrumentation** — spans and the convenience metric
  constructors here write to the process-global tracer/registry only
  while enabled (kernel launch counters, admission stage timings);
* **always-live metrics** — subsystems that *own* bookkeeping (the
  serving :class:`~repro_torch.serving.registry.MatrixRegistry` and
  engines backing their ``stats()`` views) hold :class:`MetricRegistry`
  instances directly; those count regardless of the enable flag and
  aggregate into :func:`collect` / :func:`dump` through
  :func:`repro_torch.obs.metrics.all_registries`.

Artifacts: :func:`write_trace` emits Chrome-trace JSON (load it at
https://ui.perfetto.dev), :func:`write_events` the same events as JSONL,
:func:`dump` the full metrics+span snapshot.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .metrics import (  # noqa: F401  (re-exported surface)
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    Series,
    all_registries,
    default_buckets,
    get_registry,
)
from .flight import FlightRecorder, get_flight  # noqa: F401
from .slo import SLO, SLOEngine, worst_status  # noqa: F401
from .trace import Span, Tracer, get_tracer  # noqa: F401
from .requesttrace import (  # noqa: F401
    RequestContext,
    RequestLog,
    get_request_log,
    mint_trace_id,
    new_context,
    waterfall,
)

__all__ = [
    "enabled",
    "enable",
    "disable",
    "span",
    "flow",
    "counter",
    "gauge",
    "histogram",
    "series",
    "registry",
    "tracer",
    "flight",
    "request_log",
    "collect",
    "dump",
    "write_trace",
    "write_events",
    "reset",
    "NOOP",
    "Counter",
    "Gauge",
    "Histogram",
    "Series",
    "MetricRegistry",
    "Span",
    "Tracer",
    "FlightRecorder",
    "RequestContext",
    "RequestLog",
    "SLO",
    "SLOEngine",
    "worst_status",
    "get_registry",
    "get_flight",
    "get_request_log",
    "mint_trace_id",
    "new_context",
    "waterfall",
    "all_registries",
    "default_buckets",
]


class _Noop:
    """The disabled path: one shared instance, every method a no-op.

    Duck-types every metric and the span context manager, so call sites
    never branch on the enable flag themselves.
    """

    __slots__ = ()

    def inc(self, n=1.0):
        pass

    def dec(self, n=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v, exemplar=None):
        pass

    def append(self, value, index=None):
        pass

    def extend(self, values):
        pass

    def annotate(self, **kw):
        return self

    def sync(self, value):
        return value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False


NOOP = _Noop()

_enabled = False


def enabled() -> bool:
    """Whether gated instrumentation is recording."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


# --- gated constructors (no-op while disabled) ------------------------------


def span(name: str, **args):
    """Timed scope context manager (no-op while disabled)::

        with obs.span("admit.build_tiles", matrix=name) as sp:
            tiles = build(...)
            sp.annotate(tiles=tiles.n_tiles)
    """
    return get_tracer().span(name, **args) if _enabled else NOOP


def flow(name: str, fid: str, phase: str = "s", **args) -> None:
    """Emit one Chrome-trace flow event (no-op while disabled).

    ``phase`` is ``"s"`` (start), ``"t"`` (step) or ``"f"`` (finish,
    binding to the enclosing slice); ``fid`` — the request trace id —
    joins both ends of the Perfetto arrow.
    """
    if _enabled:
        get_tracer().flow(name, fid, phase, **args)


def counter(name: str, **labels):
    return get_registry().counter(name, **labels) if _enabled else NOOP


def gauge(name: str, **labels):
    return get_registry().gauge(name, **labels) if _enabled else NOOP


def histogram(name: str, **labels):
    return get_registry().histogram(name, **labels) if _enabled else NOOP


def series(name: str, **labels):
    return get_registry().series(name, **labels) if _enabled else NOOP


# --- aggregation / artifacts ------------------------------------------------


def registry() -> MetricRegistry:
    """The process-global metric registry (live even while disabled)."""
    return get_registry()


def tracer() -> Tracer:
    """The process-global span tracer."""
    return get_tracer()


def flight() -> FlightRecorder:
    """The process-global flight recorder (always on, bounded ring)."""
    return get_flight()


def request_log() -> RequestLog:
    """The process-global request log (always on, bounded window)."""
    return get_request_log()


def collect() -> dict:
    """One snapshot of everything: all live registries + span summary."""
    t = get_tracer()
    return {
        "schema": 1,
        "enabled": _enabled,
        "registries": [r.collect() for r in all_registries()],
        "spans": t.summary(),
        "n_events": len(t.events),
        "dropped_events": t.dropped,
        "flight": get_flight().stats(),
        "requests": get_request_log().snapshot(),
    }


def dump(path) -> dict:
    """Write the full metrics+span snapshot as JSON; returns the snapshot.

    The snapshot holds counters (registry hits/misses, kernel traffic), bucket
    occupancy histograms, solver/training series, span aggregates, and
    the per-matrix amortized-preprocess ledger derived from them.
    """
    snap = collect()
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True, default=str)
    return snap


def write_trace(path) -> None:
    """Write the Chrome-trace JSON (opens in Perfetto / chrome://tracing)."""
    get_tracer().write_chrome(path)


def write_events(path) -> None:
    """Write the span events as JSONL (one event object per line)."""
    get_tracer().write_jsonl(path)


def reset() -> None:
    """Clear the global registry, tracer, flight ring and request log
    (test isolation)."""
    get_registry().reset()
    get_tracer().clear()
    get_flight().reset()
    get_request_log().clear()


def _env_truthy(v: Optional[str]) -> bool:
    return v is not None and v.strip().lower() not in ("", "0", "false", "no", "off")


if _env_truthy(os.environ.get("REPRO_OBS")):
    enable()
