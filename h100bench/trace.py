"""The ``--trace 1`` run: spans of the harness's own, the profiler over a
steady slice of the window, and the reduction of its events.

The harness marks aggregation itself, so the program needs no spans: a
``record_function`` around each call of the aggregator it hands to the
program, and one around each autograd node between that call's output and
its input (the aggregator's backward), entered and left by node hooks.
A device operation belongs to aggregation when the host launched it
inside one of those ranges, on the same thread: its launch is the CUDA
runtime or driver call of the same correlation id.  Raw profiler events
are read (``kineto_results``), not the slower ``FunctionEvent`` tree; the
card's torch (2.11) gives them no ``activity_type()``, so :func:`_kinds`
tells them apart by device, name and annotation.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

AGG = "h100bench.agg"
AGG_BWD = "h100bench.agg_bwd"
WINDOW = "h100bench.window"
_RUNTIME = re.compile(r"^(cuda[A-Z]|cu[A-Z])")
# the profiler's own bookkeeping, not the program's
_OVERHEAD = ("Activity Buffer Request", "Buffer Flush")
# a traced slice starts this far into the window and lasts this long, with
# at least MIN_STEPS steps, so its numbers come from steady state
SLICE_START = 0.25
SLICE_SECONDS = 3.0
MIN_STEPS = 3
NAME_CHARS = 160


def traced_aggregator(agg: Callable) -> Callable:
    """``agg`` with its forward and its backward marked for the trace."""

    def marked(x):
        with record_function(AGG):
            y = agg(x)
        if y.grad_fn is not None:
            _mark_backward(y, x)
        return y

    return marked


def _mark_backward(y: torch.Tensor, x: torch.Tensor) -> None:
    stop = x.grad_fn
    nodes, stack, seen, reached = [], [y.grad_fn], set(), stop is None
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        if node is stop:
            reached = True
            continue
        seen.add(id(node))
        nodes.append(node)
        stack.extend(fn for fn, _ in node.next_functions)
    if not reached:  # not a chain from x to y: mark the output's node alone
        nodes = [y.grad_fn]
    for node in nodes:
        span = record_function(AGG_BWD)

        def enter(grads, span=span):
            span.__enter__()

        def leave(inputs, outputs, span=span):
            span.__exit__(None, None, None)

        node.register_prehook(enter)
        node.register_hook(leave)


class Slice:
    """Profiles the steps of a window from ``SLICE_START`` of its length
    on, for ``SLICE_SECONDS`` (at most half the window) and ``MIN_STEPS``
    steps or more.  Call :meth:`before` and :meth:`after` around each step
    (each step ends synchronised); :meth:`events` once the window is over."""

    def __init__(self, seconds: float):
        self.start_at = SLICE_START * seconds
        self.length = min(SLICE_SECONDS, 0.5 * seconds)
        self.steps = 0
        self._prof = None
        self._window = None
        self._t0 = None
        self._done = False
        self._events = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, before the window: its first
        start (CUPTI's set-up) takes seconds."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]):
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def before(self, elapsed: float) -> None:
        if self._done or self._prof is not None or elapsed < self.start_at:
            return
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self._t0 = time.perf_counter()

    def after(self) -> None:
        if self._prof is None or self._done:
            return
        self.steps += 1
        if self.steps >= MIN_STEPS and time.perf_counter() - self._t0 >= self.length:
            self.stop()

    def stop(self) -> None:
        """End the slice (the window's end does, if it is still open)."""
        if self._prof is None or self._done:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self._done = True
        self._events = self._prof.profiler.kineto_results.events()

    def events(self):
        self.stop()
        return self._events


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    agg_device_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    device_count: int
    unlaunched: int  # device operations whose launch the trace does not hold


def _kinds(events) -> List[str]:
    """Each event's kind: ``"device"``, an operation on the device (a
    kernel, a copy or a set), unless it mirrors a host range (``"mirror"``,
    the device side of a ``record_function``); on the host ``"launch"``,
    a call of the CUDA runtime or driver API, the profiler's own
    ``"overhead"``, or ``"host"``, an operator or a range."""
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name() for e in events if e.device_type() == cpu}
    kinds = []
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            mirrored = e.is_user_annotation() or name in host_names
            kinds.append("mirror" if mirrored else "device")
        elif _RUNTIME.match(name):
            kinds.append("launch")
        elif name in _OVERHEAD or "Overhead" in name:
            kinds.append("overhead")
        else:
            kinds.append("host")
    return kinds


def summarize(events) -> Summary:
    """Busy time, aggregation's device time and the breakdown of the
    slice that ``events`` cover."""
    window, device, launches, host, agg_ranges = None, [], {}, defaultdict(list), defaultdict(list)
    for e, kind in zip(events, _kinds(events)):
        if kind == "device":
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.correlation_id()))
        elif kind == "launch":
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind == "host":
            t0, t1, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
            if name == WINDOW:
                window = (t0, t1)
                continue
            thread = e.start_thread_id()
            host[thread].append((t0, t1, name))
            if name in (AGG, AGG_BWD):
                agg_ranges[thread].append((t0, t1))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    for ranges in agg_ranges.values():
        ranges.sort()
    agg_starts = {t: [r[0] for r in rs] for t, rs in agg_ranges.items()}

    def in_agg(t: int, thread: int) -> bool:
        starts = agg_starts.get(thread)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and agg_ranges[thread][i][1] >= t

    busy_ns, agg_ns, unlaunched = [], 0, 0
    per_name = defaultdict(int)
    for t0, t1, name, corr in device:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        busy_ns.append((t0, t1))
        per_name[name[:NAME_CHARS]] += t1 - t0
        launch = launches.get(corr)
        if launch is None:
            unlaunched += 1
        elif in_agg(*launch):
            agg_ns += t1 - t0
    merged = _merge(busy_ns)
    busy = sum(b - a for a, b in merged)
    gaps = _gaps(merged, w0, w1)
    labels = _label(gaps, host)
    by_label = defaultdict(int)
    for (g0, g1), label in zip(gaps, labels):
        by_label[label] += g1 - g0
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Summary((w1 - w0) / 1e9, busy / 1e9, agg_ns / 1e9, top(per_name), top(by_label),
                   len(busy_ns), unlaunched)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(merged, w0: int, w1: int):
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _label(gaps, host) -> List[str]:
    """What the host was doing in the middle of each gap: the innermost
    host range open then, over the threads, the one opened last."""
    mids = sorted((0.5 * (a + b), i) for i, (a, b) in enumerate(gaps))
    best: List[Optional[Tuple[int, str]]] = [None] * len(gaps)
    for ranges in host.values():
        ranges.sort()
        stack, j = [], 0
        for mid, i in mids:
            while j < len(ranges) and ranges[j][0] <= mid:
                while stack and stack[-1][1] <= ranges[j][0]:
                    stack.pop()
                stack.append(ranges[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            if stack and (best[i] is None or stack[-1][0] > best[i][0]):
                best[i] = (stack[-1][0], stack[-1][2])
    return [b[1][:NAME_CHARS] if b is not None else "(no host range)" for b in best]
