"""Request-scoped tracing: one context per submitted request, always on.

The aggregate telemetry (histograms, burn rates, flight rings) answers
"how is the fleet doing?"; this module answers the per-request question a
QoS front-end has to ask: *for this specific request, how much of its
latency was queue wait vs device compute, and which requests burned the
SLO?*  Every :meth:`~repro.serving.engine.ServingEngine.submit` mints a
:class:`RequestContext` — a trace id plus monotonic stamps at submit →
enqueue → flush-start → dispatch → complete — that rides the request's
:class:`~repro.serving.batcher.SpMVRequest` through the batcher and the
flush, and is pushed into the bounded process :class:`RequestLog` on
completion.

Cost contract: this path is always live, so it must stay at
flight-recorder overhead — the context object (one ``__slots__``
instance + one short trace-id string) is the *only* per-request
allocation; stamps are plain float attribute writes, and completion is a
single bounded-deque append.  Everything derived (queue/compute
decomposition, dict rendering) happens at snapshot time, not on the hot
path.

The trace id is the join key across the whole stack: it lands as the
**exemplar** on the ``serving.latency_s`` histogram buckets
(:meth:`repro.obs.metrics.Histogram.observe`), in the flight-recorder
ring events and ``deadline_miss`` trigger context
(:mod:`repro.obs.flight`), and as Chrome-trace **flow events** in the
gated tracer (:meth:`repro.obs.trace.Tracer.flow`) so Perfetto draws the
submit→flush arrow.  ``python -m repro.analysis.report --requests DUMP``
renders the slowest-N waterfall from a ``repro.obs.dump()`` snapshot.
"""
from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from typing import List, Optional, Union

__all__ = [
    "RequestContext",
    "RequestLog",
    "mint_trace_id",
    "new_context",
    "get_request_log",
    "waterfall",
]

# one process-wide monotone sequence; itertools.count() increments under
# the GIL so minting needs no lock of its own
_SEQ = itertools.count()
_PID_TOKEN = f"{os.getpid():x}"


def mint_trace_id(kind: str = "r") -> str:
    """A short process-unique trace id, e.g. ``r3f91-1a``.

    ``kind`` prefixes the id class: ``r`` for serving requests, ``a`` for
    admissions.  The pid token keeps ids from concurrent processes (a
    serving fleet writing dumps into one directory) distinct.
    """
    return f"{kind}{_PID_TOKEN}-{next(_SEQ):x}"


class RequestContext:
    """Per-request causality record: trace id + lifecycle stamps.

    Stamps are in the *engine clock* domain (injectable, virtual in
    tests) so the queue/latency decomposition is deterministic wherever
    latency accounting is; ``compute_s`` is the flushed batch's measured
    wall compute, attributed to this request via ``batch_share``.
    """

    __slots__ = (
        "trace_id",
        "key",
        "t_submit",
        "t_enqueue",
        "t_flush_start",
        "t_dispatch",
        "t_complete",
        "compute_s",
        "batch_share",
        "batch_k",
        "flush_reason",
        "deadline_hit",
    )

    def __init__(self, key: str, t_submit: float):
        self.trace_id = mint_trace_id("r")
        self.key = key
        self.t_submit = t_submit
        self.t_enqueue: Optional[float] = None
        self.t_flush_start: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_complete: Optional[float] = None
        self.compute_s: Optional[float] = None
        self.batch_share: Optional[float] = None
        self.batch_k: Optional[int] = None
        self.flush_reason: Optional[str] = None
        self.deadline_hit: Optional[bool] = None

    # --- derived decomposition (computed at read time, never stored) -------

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Submit → flush-start: time spent coalescing in the batcher."""
        if self.t_flush_start is None:
            return None
        return self.t_flush_start - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_complete is None:
            return None
        return self.t_complete - self.t_submit

    @property
    def compute_share_s(self) -> Optional[float]:
        """This request's share of its batch's measured compute seconds."""
        if self.compute_s is None or self.batch_share is None:
            return None
        return self.compute_s * self.batch_share

    @property
    def done(self) -> bool:
        return self.t_complete is not None

    def to_dict(self) -> dict:
        """JSON-ready record for dumps and the ``--requests`` waterfall."""
        return {
            "trace_id": self.trace_id,
            "matrix": self.key,
            "t_submit": self.t_submit,
            "t_enqueue": self.t_enqueue,
            "t_flush_start": self.t_flush_start,
            "t_dispatch": self.t_dispatch,
            "t_complete": self.t_complete,
            "queue_wait_s": self.queue_wait_s,
            "compute_s": self.compute_s,
            "compute_share_s": self.compute_share_s,
            "batch_share": self.batch_share,
            "batch_k": self.batch_k,
            "flush_reason": self.flush_reason,
            "deadline_hit": self.deadline_hit,
            "latency_s": self.latency_s,
        }

    def __repr__(self) -> str:  # debugging aid, never on the hot path
        return (
            f"RequestContext({self.trace_id}, key={self.key!r}, "
            f"latency_s={self.latency_s}, queue_wait_s={self.queue_wait_s})"
        )


def new_context(key: str, t_submit: float) -> RequestContext:
    """Mint the context for one submitted request."""
    return RequestContext(key, t_submit)


class RequestLog:
    """Bounded ring of completed :class:`RequestContext` objects.

    The engine appends the context object itself (no dict per request);
    :meth:`snapshot` renders dicts only when a dump/report asks.  Like
    the flight ring, memory is bounded regardless of traffic volume.
    """

    def __init__(self, *, window: int = 1024):
        self._ctxs: deque = deque(maxlen=window)
        self._count = 0
        self._lock = threading.Lock()

    def complete(self, ctx: RequestContext) -> None:
        """Record one completed request (hot path: a deque append)."""
        with self._lock:
            self._ctxs.append(ctx)
            self._count += 1

    @property
    def count(self) -> int:
        """Total requests ever completed (the window holds the newest)."""
        return self._count

    def contexts(self) -> List[RequestContext]:
        with self._lock:
            return list(self._ctxs)

    def snapshot(self) -> List[dict]:
        """The retained window as JSON-ready dicts, oldest first."""
        return [c.to_dict() for c in self.contexts()]

    def clear(self) -> None:
        with self._lock:
            self._ctxs.clear()
            self._count = 0


_LOG: Optional[RequestLog] = None
_LOG_LOCK = threading.Lock()


def get_request_log() -> RequestLog:
    """The process-global request log (created on first use, always on)."""
    global _LOG
    with _LOG_LOCK:
        if _LOG is None:
            _LOG = RequestLog()
        return _LOG


# --- the slowest-N waterfall -------------------------------------------------


def _ms(v: Optional[float]) -> str:
    return "n/a" if v is None else f"{1e3 * v:.3f}"


def waterfall(
    snapshot_or_rows: Union[dict, List[dict]], *, n: int = 20, width: int = 32
) -> str:
    """Render the slowest-``n`` request waterfall as a text table.

    Accepts either a ``repro.obs.dump()``/``collect()`` snapshot (reads
    its ``"requests"`` list) or the request-dict list directly.  Each row
    shows the queue-vs-compute decomposition numerically and as a bar —
    ``░`` is queue wait, ``█`` the request's compute share — scaled so
    the slowest request spans ``width`` cells.
    """
    rows = (
        snapshot_or_rows.get("requests", [])
        if isinstance(snapshot_or_rows, dict)
        else list(snapshot_or_rows)
    )
    rows = [r for r in rows if r.get("latency_s") is not None]
    if not rows:
        return (
            "(no completed requests in snapshot — serve traffic through a "
            "ServingEngine first)\n"
        )
    rows.sort(key=lambda r: (-r["latency_s"], r.get("trace_id", "")))
    rows = rows[:n]
    scale = max(r["latency_s"] for r in rows)
    header = [
        "trace_id", "matrix", "latency_ms", "queue_ms", "compute_ms",
        "share", "reason", "queue░ compute█",
    ]
    table = []
    for r in rows:
        lat = r["latency_s"]
        queue = r.get("queue_wait_s")
        comp = r.get("compute_share_s")
        q_cells = int(round(width * (queue or 0.0) / scale)) if scale > 0 else 0
        c_cells = int(round(width * (comp or 0.0) / scale)) if scale > 0 else 0
        q_cells = min(q_cells, width)
        c_cells = min(c_cells, width - q_cells)
        share = r.get("batch_share")
        table.append(
            [
                str(r.get("trace_id", "?")),
                str(r.get("matrix", "?")),
                _ms(lat),
                _ms(queue),
                _ms(comp),
                "n/a" if share is None else f"1/{round(1 / share)}" if share else "0",
                str(r.get("flush_reason") or "n/a"),
                "░" * q_cells + "█" * c_cells,
            ]
        )
    widths = [max(len(h), *(len(row[i]) for row in table)) for i, h in enumerate(header)]
    lines = [f"== slowest {len(rows)} requests (queue wait vs compute share) =="]
    lines.append("  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for row in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
    return "\n".join(lines) + "\n"
