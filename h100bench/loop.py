"""The measured window of a closed loop with one caller, and what the
per-layer readers of a traced run are given."""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

from h100bench import trace as tr


class Window(NamedTuple):
    count: int  # steps or forwards completed in the window
    seconds: float  # host clock from the first issue to the last completion
    traced_steps: int  # of them, in the profiled slice
    summary: Optional[tr.Summary]


def closed_loop(step: Callable[[int], None], seconds: float, trace: bool) -> Window:
    """Calls ``step(i)`` (which returns once its work is complete on the
    device) until ``seconds`` have passed; the window holds every step it
    started.  With ``trace`` a slice of it is profiled."""
    sliced = tr.Slice(seconds) if trace else None
    if sliced is not None:
        sliced.warm()
    count = 0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        if sliced is not None:
            sliced.before(elapsed)
        step(count)
        count += 1
        if sliced is not None:
            sliced.after()
    window_s = time.perf_counter() - t0
    if sliced is None:
        return Window(count, window_s, 0, None)
    events = sliced.events()
    summary = tr.summarize(events) if events is not None else None
    return Window(count, window_s, sliced.steps, summary)


class LayerInputs(NamedTuple):
    """What a per-layer reader reads: the traced slice and the work counts."""

    steps: int  # steps or forwards in the traced slice
    window_s: float
    busy_s: float
    agg_device_s: float
    agg_bound_s: float  # per step: the aggregation's roofline bound
    model_flops: float  # per step
    peak_flops: float
    admit_s: float


def layer_inputs(window: Window, agg_bound_s: float, model_flops: float, peak_flops: float,
                 admit_s: float) -> Optional[LayerInputs]:
    s = window.summary
    if s is None:
        return None
    return LayerInputs(window.traced_steps, s.window_s, s.busy_s, s.agg_device_s, agg_bound_s,
                       model_flops, peak_flops, admit_s)
