"""GAT's full-batch training steps, one after another, through the
program's ``NodeClassifierTrainer.step`` with the registry-served attention
aggregator (``admit_pair(..., rewritable=True)``).

``train_full_graph.py``'s cell (loaded by file name) with three changes:

* the weight draw: per layer ``W`` and ``W_res`` Glorot normal ``[d_in, H
  C]``, ``a_src`` and ``a_dst`` normal ``[H, C]`` of std the
  configuration's ``attention_std``, and the bias of std ``bias_std``,
  drawn in that order (``C`` the hidden width over the configuration's
  ``heads``, the output layer's whole);
* the work counts, which take the heads;
* the measured window, ``loop.closed_loop`` with the traced slice's
  events kept (as ``h100bench.spans`` keeps them, by wrapping
  ``trace.summarize`` in this process): readers get ``LayerInputs``'
  fields, the SDDMM's bound a step and the slice by the program's ranges
  (``spans.reduce``).  The harness's ``AGG`` range marks the whole
  attention aggregation, its forward call and its autograd node.

The ``"altered"`` fault of ``faults.py`` patches ``MatrixPlan.aggregate``
and ``diff_aggregator``, which the attention aggregation does not call:
while it is planted, ``remake`` gives an attention aggregator altered the
same way (node 0's aggregated row, +1).

The checks and the reference (``reference/gat.py``) are the train cell's.
"""
from __future__ import annotations

import collections
import math
import time
from typing import List, Tuple

import torch
from torch.autograd.profiler import record_function

from h100bench import check, data, harness, loop, spans, work
from h100bench import trace as tr
from h100bench.peaks import peaks_for

base = harness.load_module(harness.HERE / "drivers" / "train_full_graph.py")

FAULTS = ("unchanged", "half_batch", "altered")


# what the readers get: ``loop.LayerInputs``' fields, then the SDDMM's
# bound a step and the slice by the program's ranges (``spans.Spans``)
GatLayer = collections.namedtuple("GatLayer", (*loop.LayerInputs._fields, "sddmm_bound_s",
                                               "spans"))


def gat_weights(gen: torch.Generator, dims, heads: int, std: float,
                bias_std: float) -> List[Tuple[torch.Tensor, ...]]:
    """One ``(W, W_res, a_src, a_dst, b)`` a layer, drawn in that order."""
    layers = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        width = d_out if i == len(dims) - 2 else d_out // heads
        glorot = (2.0 / (d_in + heads * width)) ** 0.5

        def normal(shape, scale):
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device) * scale

        w, w_res = normal((2, d_in, heads * width), glorot).unbind(0)
        a_src, a_dst = normal((2, heads, width), std).unbind(0)
        layers.append((w, w_res, a_src, a_dst, normal((d_out,), bias_std)))
    return layers


def marked(agg):
    """``agg`` with its forward call and its autograd node marked for the
    trace (the harness's ``AGG`` and ``AGG_BWD`` ranges)."""

    def call(z, s_src, s_dst):
        with record_function(tr.AGG):
            y = agg(z, s_src, s_dst)
        if y.grad_fn is not None:
            span = record_function(tr.AGG_BWD)

            def enter(grads):
                span.__enter__()

            def leave(inputs, outputs):
                span.__exit__(None, None, None)

            y.grad_fn.register_prehook(enter)
            y.grad_fn.register_hook(leave)
        return y

    return call


def altered(agg):
    """``agg`` with node 0's aggregated row +1 (``faults.py``'s
    ``"altered"``)."""

    def call(z, s_src, s_dst):
        y = agg(z, s_src, s_dst).clone()
        y[0] = y[0] + 1.0
        return y

    return call


def closed_loop(step, seconds: float, trace: bool):
    """``loop.closed_loop``'s window, and the traced slice's events (None
    untraced): the events ``trace.summarize`` is given, kept on the way."""
    kept, summarize = [], tr.summarize

    def keep(events):
        kept.append(events)
        return summarize(events)

    tr.summarize = keep
    try:
        window = loop.closed_loop(step, seconds, trace)
    finally:
        tr.summarize = summarize
    return window, (kept[-1] if kept else None)


class TrainGat(base.Train):
    def remake(self) -> float:
        """``Train.remake``, the aggregator altered while ``faults.py``'s
        ``"altered"`` is planted (it has replaced
        ``MatrixPlan.aggregate``)."""
        from repro_torch.serving.registry import MatrixPlan

        seconds = super().remake()
        if MatrixPlan.aggregate.__qualname__ != "MatrixPlan.aggregate":
            self.agg = altered(self.agg)
        return seconds

    def start(self, seed: int):
        """``Train.start`` with GAT's weight draw."""
        cfg, wl = self.ctx.config, self.ctx.workload
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = data.features(gen, self.graph.n, cfg["dims"][0])
        labels = data.labels(gen, x, cfg["dims"][-1])
        params0 = gat_weights(gen, cfg["dims"], cfg["heads"], cfg["attention_std"],
                              cfg["bias_std"])
        state = self.trainer.load_state([[t.cpu().numpy() for t in p] for p in params0])
        losses, first, norm = [], None, None
        for i in range(wl["checked_steps"]):
            state, out = self.trainer.step(state, self.agg, x, labels)
            losses.append(out["loss"])
            if i == 0:  # the first moment holds (1 - b1) * clip * g
                norm = out["grad_norm"]
                clip = min(1.0, cfg["adamw"]["grad_clip"] / max(norm, 1e-9))
                first = [m.detach() / ((1.0 - cfg["adamw"]["b1"]) * clip)
                         for m in check.flat(state.opt_state["m"])]
        params = [p.detach().clone() for p in check.flat(state.params)]
        for _ in range(wl["warmup_steps"]):
            state, _ = self.trainer.step(state, self.agg, x, labels)
        return base.Session(x, labels, params0, losses, first, norm, params, state)

    def window(self, session, seconds: float, trace: bool):
        """The measured steps: the window, its traced events and the
        non-finite losses."""
        agg = marked(self.agg) if trace else self.agg
        box = {"state": session.state, "failed": 0}

        def step(_):
            box["state"], out = self.trainer.step(box["state"], agg, session.x, session.labels)
            box["failed"] += not math.isfinite(out["loss"])

        window, events = closed_loop(step, seconds, trace)
        return window, events, box["failed"]

    def work(self):
        cfg, g = self.ctx.config, self.graph
        counts = harness.arch_module("work", cfg)
        return counts.step_work(cfg["dims"], g.n, counts.nnz(g), train=True, heads=cfg["heads"])


Cell = TrainGat
readings = base.readings


def run(ctx) -> dict:
    cell = TrainGat(ctx)
    session = cell.start(ctx.seed)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0
    window, events, failed = cell.window(session, ctx.seconds, ctx.trace)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    steps = cell.work()
    layer = None
    if ctx.device.type == "cuda":
        peaks = peaks_for(torch.cuda.get_device_name(ctx.device))
        inputs = loop.layer_inputs(
            window, work.bound_s(steps["aggregation"], peaks),
            work.total(steps["aggregation"] + steps["dense"]).flops, peaks.fp32_flops,
            cell.admit_s)
        if inputs is not None:
            layer = GatLayer(*inputs, work.bound_s(steps["sddmm"], peaks), spans.reduce(events))
    session = session._replace(state=None)
    cell.release()
    numbers = check.train_numbers(cell.judge(session), len(session.params0[-1]))
    return {
        "e2e": {"train_step_ms": 1e3 * window.seconds / max(window.count, 1),
                "setup_s": setup_s},
        "attempted": window.count,
        "failed": failed,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "layer": layer,
        "summary": window.summary,
    }
