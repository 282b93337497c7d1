"""Span tracer: nested timing scopes exported as Chrome-trace / JSONL.

``span("admit.build_tiles")`` opens a timed scope; on exit one *complete*
event (Chrome ``"ph": "X"``) is appended to the process-global
:class:`Tracer`.  Nesting needs no bookkeeping in the export — the Chrome
trace viewer and Perfetto nest same-thread events by time containment —
but each event also carries an explicit ``depth`` (the thread's open-span
count at entry) so tests and the JSONL log can assert ordering without a
trace viewer.

CUDA work is asynchronous: a span that closes right after a kernel
launch times the *dispatch*, not the compute.  ``Span.sync(value)``
synchronizes the card when ``value`` holds CUDA tensors, so the caller
decides, per span, whether the device is drained inside the measurement::

    with obs.span("serve.flush", matrix=key) as sp:
        y = sp.sync(plan.matmat(X))   # compute lands inside the span

The event buffer is bounded (default 1M events); past the cap events are
dropped and counted, never silently lost.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer"]


class Tracer:
    """Bounded event buffer with Chrome-trace and JSONL exporters."""

    def __init__(self, *, max_events: int = 1_000_000):
        self.max_events = max_events
        self.epoch = time.perf_counter()
        self.events: List[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._tls = threading.local()

    # --- span lifecycle ----------------------------------------------------

    def span(self, name: str, **args) -> "Span":
        return Span(self, name, args)

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def _enter(self) -> int:
        d = self._depth()
        self._tls.depth = d + 1
        return d

    def _exit(self) -> None:
        self._tls.depth = max(0, self._depth() - 1)

    def add_event(
        self, name: str, t0: float, t1: float, depth: int, args: Dict[str, object]
    ) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0 - self.epoch) * 1e6,  # Chrome trace wants microseconds
            "dur": (t1 - t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "depth": depth,
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._append(ev)

    def flow(
        self, name: str, fid: str, phase: str = "s", t: Optional[float] = None, **args
    ) -> None:
        """Append one Chrome-trace **flow event** (``ph`` s/t/f).

        Flow events draw arrows between slices in Perfetto: a ``"s"``
        (start) at submit time and an ``"f"`` (finish, binding to the
        enclosing slice) inside the flush span connect a request's
        submission to the batch that served it.  ``fid`` is the flow id —
        the request's trace id — shared by both ends of the arrow.
        """
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s, t or f, got {phase!r}")
        t = time.perf_counter() if t is None else t
        ev = {
            "name": name,
            "ph": phase,
            "cat": "request",
            "id": str(fid),
            "ts": (t - self.epoch) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if phase == "f":
            ev["bp"] = "e"  # bind to the enclosing slice, not the next one
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._append(ev)

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
            else:
                self.events.append(ev)

    # --- introspection / export --------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.events)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0

    def summary(self) -> List[dict]:
        """Per-span-name aggregate: count, total/mean/max duration (ms).

        Flow events carry no duration and are skipped — they annotate
        causality, not time spent."""
        agg: Dict[str, List[float]] = {}
        for ev in self.snapshot():
            if "dur" not in ev:
                continue
            agg.setdefault(ev["name"], []).append(ev["dur"])
        out = []
        for name in sorted(agg, key=lambda n: (-sum(agg[n]), n)):
            durs = agg[name]
            out.append(
                {
                    "name": name,
                    "count": len(durs),
                    "total_ms": sum(durs) / 1e3,
                    "mean_ms": sum(durs) / len(durs) / 1e3,
                    "max_ms": max(durs) / 1e3,
                }
            )
        return out

    def chrome_trace(self) -> dict:
        """The ``{"traceEvents": [...]}`` object Perfetto / chrome://tracing
        load directly."""
        return {
            "traceEvents": self.snapshot(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_jsonl(self, path) -> None:
        """One event object per line — greppable, streamable, diffable."""
        with open(path, "w") as f:
            for ev in self.snapshot():
                f.write(json.dumps(ev, sort_keys=True) + "\n")


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class Span:
    """One timed scope.  Use as a context manager; re-entrant per instance
    is not supported (make a new span instead)."""

    __slots__ = ("tracer", "name", "args", "t0", "depth")

    def __init__(self, tracer: Tracer, name: str, args: Dict[str, object]):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "Span":
        self.depth = self.tracer._enter()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self.tracer._exit()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.tracer.add_event(self.name, self.t0, t1, self.depth, self.args)
        return False

    def annotate(self, **kw) -> "Span":
        """Attach args discovered mid-span (tile counts, chosen configs)."""
        self.args.update(kw)
        return self

    def sync(self, value):
        """Block until ``value``'s device work is done; returns ``value``.
        Use inside the span so asynchronous dispatch lands in the timing.

        CUDA launches return before the card finishes, so when ``value``
        holds a CUDA tensor (directly or inside a list, tuple or dict)
        this waits on the device with ``torch.cuda.synchronize()``.
        """
        if _holds_cuda_tensor(value):
            import torch

            torch.cuda.synchronize()
        return value


def _holds_cuda_tensor(value) -> bool:
    if isinstance(value, (list, tuple)):
        return any(_holds_cuda_tensor(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_cuda_tensor(v) for v in value.values())
    return bool(getattr(value, "is_cuda", False))


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (created on first use)."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer()
        return _TRACER
