"""Always-on flight recorder: a bounded ring of events + anomaly dumps.

The gated tracer (:mod:`repro.obs.trace`) answers "what happened?" only if
observability was enabled *before* the interesting thing happened.
Production serving needs the opposite: a recorder that is **always on**,
costs a bounded ring slot per event, and can explain — after the fact —
why a request missed its deadline.  :class:`FlightRecorder` is that
recorder:

* **fixed ring capacity** — events land in a preallocated ring buffer;
  once full, the oldest events are overwritten (never an allocation-
  per-event growth path, never unbounded memory);
* **lock-cheap recording** — one small critical section per event (a slot
  write and an index bump); hot call sites that cannot afford even a dict
  per call use :meth:`sampled` to record probabilistically;
* **anomaly triggers** — :meth:`trigger` snapshots the ring to a
  Perfetto-loadable artifact ``flight_<reason>_<seq>.json``.  The serving
  engine fires it on deadline misses; :meth:`observe_latency` fires it
  when an observation exceeds a rolling-quantile threshold, and
  :meth:`observe_queue_depth` when a queue saturates.  Dumps are
  rate-limited per reason and capped per process so a pathological
  workload cannot flood the disk.

The artifact is the same Chrome-trace JSON shape the tracer exports
(``{"traceEvents": [...]}``): drop it on https://ui.perfetto.dev and the
ring replays as spans (``ph: "X"``) and instants (``ph: "i"``), with the
trigger context under ``otherData``.
"""
from __future__ import annotations

import json
import os
import random
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "get_flight", "DEFAULT_DUMP_DIR"]

# where trigger dumps land when neither the recorder's ``dump_dir`` nor
# ``$REPRO_FLIGHT_DIR`` is set — a dedicated (gitignored) subdirectory, so
# the default can never pollute a repository checkout's root
DEFAULT_DUMP_DIR = ".flight_dumps"


def _safe_token(s: str, maxlen: int = 40) -> str:
    """Filesystem-safe slice of a trace id for dump filenames."""
    return re.sub(r"[^A-Za-z0-9_.-]", "", s)[:maxlen]


class _NoopSpan:
    """Shared no-op for unsampled spans — enter/exit/annotate do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def annotate(self, **kw):
        return self


_NOOP_SPAN = _NoopSpan()


class _Rolling:
    """Per-site rolling latency window with a cached anomaly threshold.

    The threshold (``factor`` × the window's p99) is recomputed every
    ``refresh`` observations, not per observation — the hot path pays a
    float compare and a deque append.
    """

    __slots__ = ("window", "threshold", "since_refresh")

    def __init__(self, maxlen: int):
        self.window: deque = deque(maxlen=maxlen)
        self.threshold = float("inf")
        self.since_refresh = 0


class _FlightSpan:
    """Timed scope that records into the ring on exit."""

    __slots__ = ("recorder", "name", "args", "t0")

    def __init__(self, recorder: "FlightRecorder", name: str, args: dict):
        self.recorder = recorder
        self.name = name
        self.args = args

    def __enter__(self) -> "_FlightSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.recorder.record(self.name, t0=self.t0, dur_s=t1 - self.t0, **self.args)
        return False

    def annotate(self, **kw) -> "_FlightSpan":
        self.args.update(kw)
        return self


class FlightRecorder:
    """Bounded always-on event ring with triggerable post-mortem dumps."""

    def __init__(
        self,
        *,
        capacity: int = 4096,
        dump_dir: Optional[os.PathLike] = None,
        max_dumps: int = 64,
        min_dump_interval_s: float = 1.0,
        seed: Optional[int] = None,
        latency_window: int = 512,
        latency_min_samples: int = 32,
        latency_factor: float = 4.0,
        latency_refresh: int = 64,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # None: $REPRO_FLIGHT_DIR at dump time, else ./.flight_dumps/ — never
        # the bare cwd, so an example run can't litter a repo checkout with
        # flight_*.json artifacts (they are post-mortems, not source)
        self.dump_dir = dump_dir
        self.max_dumps = max_dumps
        self.min_dump_interval_s = min_dump_interval_s
        self.latency_window = latency_window
        self.latency_min_samples = latency_min_samples
        self.latency_factor = latency_factor
        self.latency_refresh = latency_refresh
        self.epoch = time.perf_counter()
        self._ring: List[Optional[dict]] = [None] * capacity
        self._n = 0  # total events ever recorded
        self._seq = 0  # dump sequence number
        self._last_dump: Dict[str, float] = {}
        self._suppressed = 0  # triggers rate-limited away (still counted)
        self.dumps: List[str] = []
        self._lat: Dict[str, _Rolling] = {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    # --- recording ---------------------------------------------------------

    def record(
        self, name: str, *, t0: Optional[float] = None, dur_s: float = 0.0, **args
    ) -> None:
        """Append one event to the ring (span if ``dur_s`` > 0, else instant).

        ``t0`` is the ``time.perf_counter`` start of the event (defaults to
        now); overwrites the oldest slot once the ring is full.
        """
        t0 = time.perf_counter() if t0 is None else t0
        ev = {
            "name": name,
            "ph": "X" if dur_s > 0 else "i",
            "ts": (t0 - self.epoch) * 1e6,  # Chrome trace wants microseconds
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if dur_s > 0:
            ev["dur"] = dur_s * 1e6
        else:
            ev["s"] = "t"  # Perfetto instant scope: thread
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._ring[self._n % self.capacity] = ev
            self._n += 1

    def span(self, name: str, *, sample: float = 1.0, **args):
        """Timed scope recorded on exit; ``sample`` < 1 records that
        fraction of entries (the unsampled rest cost one RNG draw)."""
        if sample < 1.0 and not self.sampled(sample):
            return _NOOP_SPAN
        return _FlightSpan(self, name, args)

    def sampled(self, rate: float) -> bool:
        """One probabilistic sampling decision (true ~``rate`` of calls)."""
        return self._rng.random() < rate

    # --- anomaly detectors -------------------------------------------------

    def observe_latency(self, site: str, value_s: float, **context) -> Optional[str]:
        """Feed one latency observation; trigger a dump when it exceeds the
        site's rolling-quantile threshold (``latency_factor`` × rolling p99
        over the last ``latency_window`` observations).  Returns the dump
        path when one was written."""
        with self._lock:
            r = self._lat.get(site)
            if r is None:
                r = self._lat[site] = _Rolling(self.latency_window)
            anomalous = (
                len(r.window) >= self.latency_min_samples and value_s > r.threshold
            )
            threshold = r.threshold
            r.window.append(value_s)
            r.since_refresh += 1
            if r.since_refresh >= self.latency_refresh or (
                threshold == float("inf")
                and len(r.window) >= self.latency_min_samples
            ):
                lat = sorted(r.window)
                r.threshold = self.latency_factor * lat[int(0.99 * (len(lat) - 1))]
                r.since_refresh = 0
        if not anomalous:
            return None
        return self.trigger(
            "latency_anomaly",
            site=site,
            value_s=value_s,
            threshold_s=threshold,
            **context,
        )

    def observe_queue_depth(
        self, site: str, depth: int, limit: int, **context
    ) -> Optional[str]:
        """Trigger a dump when ``depth`` saturates ``limit`` (an int compare
        on the non-saturated path — cheap enough for submit loops)."""
        if limit <= 0 or depth < limit:
            return None
        return self.trigger(
            "queue_saturation", site=site, depth=depth, limit=limit, **context
        )

    # --- triggers / dumps --------------------------------------------------

    def trigger(self, reason: str, **context) -> Optional[str]:
        """Snapshot the ring to ``flight_<reason>_<seq>[_<trace>].json``.

        Rate-limited: at most one dump per ``reason`` per
        ``min_dump_interval_s`` and ``max_dumps`` total per process
        (suppressed triggers are counted, not lost silently).  The trigger
        itself lands in the ring first, so the artifact records why it
        exists.  A ``trace_ids=[...]`` context entry names the offending
        requests: it rides the trigger event and the dump's context, and
        the first id is appended to the filename so an on-disk post-mortem
        directory can be grepped by request.  Returns the path written,
        or None when suppressed.
        """
        now = time.time()
        with self._lock:
            last = self._last_dump.get(reason)
            if self._seq >= self.max_dumps or (
                last is not None and now - last < self.min_dump_interval_s
            ):
                self._suppressed += 1
                return None
            self._last_dump[reason] = now
            seq = self._seq
            self._seq += 1
        self.record("flight.trigger", reason=reason, **context)
        directory = Path(
            self.dump_dir
            if self.dump_dir is not None
            else os.environ.get("REPRO_FLIGHT_DIR", DEFAULT_DUMP_DIR)
        )
        directory.mkdir(parents=True, exist_ok=True)
        stem = f"flight_{reason}_{seq}"
        trace_ids = context.get("trace_ids")
        if trace_ids:
            tok = _safe_token(str(trace_ids[0]))
            if tok:
                stem = f"{stem}_{tok}"
        path = directory / f"{stem}.json"
        payload = {
            "traceEvents": self.snapshot(),
            "displayTimeUnit": "ms",
            "otherData": {
                "reason": reason,
                "seq": seq,
                "context": {k: _jsonable(v) for k, v in sorted(context.items())},
                "recorded_total": self._n,
                "capacity": self.capacity,
            },
        }
        with open(path, "w") as f:
            json.dump(payload, f, sort_keys=True)
        with self._lock:
            self.dumps.append(str(path))
        return str(path)

    # --- introspection -----------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Ring contents oldest-first (sorted by timestamp for stability
        under concurrent recorders)."""
        with self._lock:
            if self._n <= self.capacity:
                events = [e for e in self._ring[: self._n]]
            else:
                head = self._n % self.capacity
                events = self._ring[head:] + self._ring[:head]
        return sorted(events, key=lambda e: (e["ts"], e["name"]))

    def stats(self) -> dict:
        with self._lock:
            return {
                "recorded_total": self._n,
                "events": min(self._n, self.capacity),
                "capacity": self.capacity,
                "overwritten": max(0, self._n - self.capacity),
                "dumps": list(self.dumps),
                "suppressed_triggers": self._suppressed,
            }

    def reset(self) -> None:
        """Clear the ring, detectors and dump bookkeeping (test isolation)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._n = 0
            self._seq = 0
            self._last_dump.clear()
            self._suppressed = 0
            self.dumps = []
            self._lat.clear()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        # bounded: ring slots must stay small even if a caller passes a
        # large batch's trace-id list by mistake
        return [_jsonable(x) for x in v[:64]]
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


_FLIGHT: Optional[FlightRecorder] = None
_FLIGHT_LOCK = threading.Lock()


def get_flight() -> FlightRecorder:
    """The process-global flight recorder (created on first use, always on)."""
    global _FLIGHT
    with _FLIGHT_LOCK:
        if _FLIGHT is None:
            _FLIGHT = FlightRecorder()
        return _FLIGHT
