"""SLO engine: declarative objectives evaluated as multi-window burn rates.

A serving deployment does not want raw latency histograms at decision
time — it wants "are we spending our error budget too fast?".  That is a
**burn rate**: the fraction of requests violating the objective over a
trailing window, divided by the budget the objective allows.  A burn rate
of 1.0 spends the budget exactly at the sustainable pace; 14x on a short
window is the classic page-now signal, ~2x on a long window the slow leak
worth a ticket.

:class:`SLO` declares one objective:

* ``objective="deadline_hit_ratio"`` — ``target`` is the required hit
  ratio (e.g. 0.99: at most 1% of requests may miss their deadline);
* ``objective="latency_p99"`` — ``target`` is a latency bound in seconds
  that 99% of requests must meet (budget fixed at 1%).

Both reduce to the same good-events accounting, so one engine evaluates
any mix of objectives per matrix/tenant key.  :class:`SLOEngine.record`
is the hot-path call (a deque append); :meth:`SLOEngine.evaluate` scans
the trailing events once per window set, refreshes the always-live
``slo.burn_rate`` / ``slo.attainment`` gauges, and classifies each
(key, slo) as ``ok`` / ``warn`` / ``page`` — the view
:meth:`repro.serving.engine.ServingEngine.health` hands the QoS layer.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Iterable, Optional, Tuple

from .metrics import MetricRegistry

__all__ = ["SLO", "SLOEngine", "DEFAULT_WINDOWS", "worst_status"]

# trailing evaluation windows in seconds, shortest first (1m / 5m / 1h)
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 300.0, 3600.0)

_OBJECTIVES = ("deadline_hit_ratio", "latency_p99")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective (see module docstring for semantics)."""

    name: str
    objective: str
    target: float
    windows: Tuple[float, ...] = DEFAULT_WINDOWS
    fast_burn: float = 14.0  # page: budget burning this fast on short windows
    slow_burn: float = 2.0  # warn: sustained burn on the longest window

    def __post_init__(self):
        if self.objective not in _OBJECTIVES:
            raise ValueError(
                f"unknown objective {self.objective!r} (expected one of {_OBJECTIVES})"
            )
        if self.objective == "deadline_hit_ratio" and not 0.0 < self.target < 1.0:
            raise ValueError(
                f"deadline_hit_ratio target must be in (0, 1), got {self.target}"
            )
        if self.objective == "latency_p99" and self.target <= 0:
            raise ValueError(f"latency_p99 target must be > 0 s, got {self.target}")
        if not self.windows or any(
            b <= a for a, b in zip(self.windows, self.windows[1:])
        ):
            raise ValueError(f"windows must be ascending and non-empty: {self.windows}")

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (the error budget)."""
        if self.objective == "deadline_hit_ratio":
            return 1.0 - self.target
        return 0.01  # latency_p99: 1% of requests may exceed the bound

    def good(self, latency_s: float, deadline_hit: bool) -> bool:
        if self.objective == "deadline_hit_ratio":
            return deadline_hit
        return latency_s <= self.target


class SLOEngine:
    """Evaluate a set of :class:`SLO` objectives per matrix/tenant key.

    ``metrics`` is where the ``slo.*`` gauges live — pass the serving
    registry's shared :class:`MetricRegistry` so burn rates ride the same
    always-live ledger as the traffic counters (and surface in
    ``repro.obs.dump()`` / the dashboard); defaults to a private one.
    ``max_events`` bounds per-key memory regardless of traffic volume.
    """

    def __init__(
        self,
        slos: Optional[Iterable[SLO]] = None,
        *,
        metrics: Optional[MetricRegistry] = None,
        clock=time.perf_counter,
        max_events: int = 65536,
    ):
        self.slos = tuple(slos) if slos is not None else (
            SLO("deadline", "deadline_hit_ratio", 0.99),
        )
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.metrics = metrics if metrics is not None else MetricRegistry(name="slo")
        self.clock = clock
        self.max_events = max_events
        # one event stream per key, shared by every objective:
        # (t_done, latency_s, deadline_hit)
        self._events: Dict[str, deque] = {}

    @property
    def max_window(self) -> float:
        return max(w for s in self.slos for w in s.windows)

    def record(
        self,
        key: str,
        *,
        latency_s: float,
        deadline_hit: bool,
        now: Optional[float] = None,
    ) -> None:
        """One completed request (hot path: an append and a bounded prune)."""
        now = self.clock() if now is None else now
        q = self._events.get(key)
        if q is None:
            q = self._events[key] = deque(maxlen=self.max_events)
        q.append((now, float(latency_s), bool(deadline_hit)))
        horizon = now - self.max_window
        while q and q[0][0] < horizon:
            q.popleft()

    def keys(self):
        return list(self._events)

    def evaluate(
        self, key: Optional[str] = None, now: Optional[float] = None
    ) -> dict:
        """Burn rates + status per (key, slo); refreshes the slo.* gauges.

        Returns ``{key: {slo_name: {"status", "budget", "windows": {label:
        {"events", "bad", "attainment", "burn_rate"}}}}}``.  Windows with
        no events report ``attainment``/``burn_rate`` of None and never
        page (no data is not an outage — queue-depth triggers cover the
        nothing-completes failure mode).
        """
        now = self.clock() if now is None else now
        keys = self.keys() if key is None else [key]
        out = {}
        for k in keys:
            events = list(self._events.get(k, ()))
            out[k] = {slo.name: self._eval_one(k, slo, events, now) for slo in self.slos}
        return out

    def _eval_one(self, key: str, slo: SLO, events, now: float) -> dict:
        windows = slo.windows
        totals = [0] * len(windows)
        bads = [0] * len(windows)
        for t, latency_s, hit in reversed(events):
            age = now - t
            if age > windows[-1]:
                break
            bad = not slo.good(latency_s, hit)
            for i, w in enumerate(windows):
                if age <= w:
                    totals[i] += 1
                    if bad:
                        bads[i] += 1
        burns, report = [], {}
        for i, w in enumerate(windows):
            n, b = totals[i], bads[i]
            ratio = (b / n) if n else None
            burn = (ratio / slo.budget) if ratio is not None else None
            attainment = (1.0 - ratio) if ratio is not None else None
            burns.append(burn)
            label = _window_label(w)
            report[label] = {
                "events": n,
                "bad": b,
                "attainment": attainment,
                "burn_rate": burn,
            }
            self.metrics.gauge(
                "slo.burn_rate", matrix=key, slo=slo.name, window=label
            ).set(burn if burn is not None else 0.0)
            self.metrics.gauge(
                "slo.attainment", matrix=key, slo=slo.name, window=label
            ).set(attainment if attainment is not None else 1.0)
        status = _classify(burns, slo)
        return {"status": status, "budget": slo.budget, "windows": report}


def _classify(burns, slo: SLO) -> str:
    """Multi-window classification: ``page`` needs the two shortest windows
    both burning past ``fast_burn`` (a lone short-window spike of a few
    requests should not page); ``warn`` is a sustained burn on the longest
    window past ``slow_burn``."""
    fast = [b for b in burns[:2] if b is not None]
    if fast and all(b >= slo.fast_burn for b in fast):
        return "page"
    if burns[-1] is not None and burns[-1] >= slo.slow_burn:
        return "warn"
    return "ok"


def _window_label(w: float) -> str:
    return f"{int(w)}s" if float(w).is_integer() else f"{w}s"


def worst_status(statuses: Iterable[str]) -> str:
    """The most severe of a set of SLO statuses (ok < warn < page)."""
    rank = {"ok": 0, "warn": 1, "page": 2}
    worst = "ok"
    for s in statuses:
        if rank.get(s, 0) > rank[worst]:
            worst = s
    return worst
