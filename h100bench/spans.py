"""A traced run of one cell, read by the program's own ranges.

    python3 -m h100bench.spans --workload <cell> --seed <n> --seconds <s>

The port's spans are profiler ranges named ``repro_torch.<span>`` while a
profiler records.  This runs the cell as ``h100bench.run --trace 1`` does
and prints its result line with one key more, ``program_spans``: the
traced slice by those ranges, a step or a forward (:func:`readings`).
The benchmark's own runs never run this, and no per-layer metric reads it
yet: :func:`reduce` takes the same events as ``trace.summarize``.

For each range name, :func:`reduce` records the ranges that start in the
slice, the device time of operations launched inside one on the launching
thread (the rule of ``trace.summarize``'s aggregation), the idle gaps in
which it was the innermost program range (over threads, the one opened
last), and the kernel launch and synchronize calls made while one was
open on any thread: the backward launches from autograd's thread while
the main thread waits in the step.  It also records the idle gaps inside
no program range.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, NamedTuple  # noqa: E402

from h100bench import trace as tr  # noqa: E402

PROGRAM = "repro_torch."  # what the program's own ranges are named by
NO_RANGE = "(no host range)"  # ``trace._label``'s label of a gap inside no range
_KERNEL_LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
_SYNC = re.compile(r"^cuda(Stream|Device|Event)Synchronize$")


class SpanStats(NamedTuple):
    """The slice by one of the program's ranges, over every thread."""

    count: int  # ranges that started in the slice
    device_s: float  # device time of operations launched inside one, on that thread
    idle_s: float  # idle gaps in which it was the innermost program range
    launches: int  # kernel launch calls made while one was open on any thread
    syncs: int  # synchronize calls made while one was open on any thread


class Spans(NamedTuple):
    window_s: float
    by_name: Dict[str, SpanStats]  # keyed by span name, without ``PROGRAM``
    unspanned_idle_s: float  # idle gaps inside no program range


def reduce(events) -> Spans:
    """The slice that ``events`` cover, by the program's ranges."""
    window, device, launches, calls, program = None, [], {}, [], defaultdict(list)
    for e, kind in zip(events, tr._kinds(events)):
        if kind == "device":
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif kind == "launch":
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            calls.append((e.start_ns(), e.name()))
        elif kind == "host":
            t0, t1, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
            if name == tr.WINDOW:
                window = (t0, t1)
            elif name.startswith(PROGRAM):
                program[e.start_thread_id()].append((t0, t1, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {tr.WINDOW} range")
    w0, w1 = window
    busy, launched = [], []  # launched: (device ns in the window, launch)
    for t0, t1, corr in device:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        busy.append((t0, t1))
        if corr in launches:
            launched.append((t1 - t0, launches[corr]))
    idle = defaultdict(int)
    gaps = tr._gaps(tr._merge(busy), w0, w1)
    for (g0, g1), label in zip(gaps, tr._label(gaps, program)):
        idle[label] += g1 - g0
    calls = [(t, call) for t, call in calls if w0 <= t <= w1]
    names = sorted({r[2] for ranges in program.values() for r in ranges})
    by_name = {}
    for name in names:
        per_thread = {thread: tr._merge([r[:2] for r in ranges if r[2] == name])
                      for thread, ranges in program.items()}
        any_thread = tr._merge([r for rs in per_thread.values() for r in rs])
        inside = [call for t, call in calls if _inside(any_thread, t)]
        by_name[name[len(PROGRAM):]] = SpanStats(
            sum(1 for ranges in program.values() for r in ranges
                if r[2] == name and w0 <= r[0] <= w1),
            sum(ns for ns, (t, thread) in launched
                if _inside(per_thread.get(thread, []), t)) / 1e9,
            idle[name[:tr.NAME_CHARS]] / 1e9,
            sum(1 for c in inside if _KERNEL_LAUNCH.match(c)),
            sum(1 for c in inside if _SYNC.match(c)))
    return Spans((w1 - w0) / 1e9, by_name, idle[NO_RANGE] / 1e9)


def _inside(merged, t: int) -> bool:
    """Whether ``t`` lies in one of the sorted disjoint intervals ``merged``."""
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][1] >= t


def readings(spans: Spans, steps: int) -> Dict[str, float]:
    """A step's (``train.step`` in the slice) or a forward's readings:
    device ms launched in the aggregation's forward and backward and in
    the unpermute, % of the slice idle in the host reads and in no range,
    and the launch and synchronize calls inside the step or the forward.
    A reading whose range is not in the slice is left out."""
    by, out = spans.by_name, {}
    kind = "train" if "train.step" in by else "infer"
    pct = lambda s: 100.0 * s / spans.window_s
    if steps <= 0 or spans.window_s <= 0 or (kind == "infer" and "gnn.forward" not in by):
        return out
    if kind == "train":
        for key, name in (("agg_fwd_ms", "agg.forward"), ("agg_bwd_ms", "agg.backward")):
            if name in by:
                out[f"{key}.train"] = 1e3 * by[name].device_s / steps
        if "train.host_read" in by:
            out["read_idle.train"] = pct(by["train.host_read"].idle_s)
        out["syncs.train"] = by["train.step"].syncs / steps
    if "kernels.unpermute" in by:
        out[f"unpermute_ms.{kind}"] = 1e3 * by["kernels.unpermute"].device_s / steps
    out[f"unspanned_idle.{kind}"] = pct(spans.unspanned_idle_s)
    out[f"launches.{kind}"] = by["train.step" if kind == "train" else "gnn.forward"].launches / steps
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.spans",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    args = p.parse_args(argv)

    from h100bench import harness

    harness.import_program()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    got, summarize = [], tr.summarize

    def both(events):  # the harness's reduction, and this one of the same events
        got.append(reduce(events))
        return summarize(events)

    tr.summarize = both
    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds, True,
                                torch.device("cuda", 0), T0)
    finally:
        tr.summarize = summarize
    steps = line.get("traced", {}).get("steps", 0)
    line["program_spans"] = readings(got[-1], steps) if got else {}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
