"""Requests of one resident sparse matrix times a block of vectors, one
after another: each request is ``plan.matmat(x)`` on the registry's plan of
the configuration's adjacency (the program's own convention,
``NodeClassifierTrainer.prepare_adjacency`` of its ``program`` ``model``:
GCN's ``Â``), with ``x`` ``[n, k]`` the next of a pool of blocks drawn
from the seed.

Set-up builds the graph, admits the adjacency (``MatrixRegistry.admit``)
and warms the product up.  Each request of the window is timed on the
device's clock from its issue to a ``torch.cuda.synchronize()``.  The
answers to a few requests drawn from the seed, and to the last one, are
kept and compared once the window has closed with the matrix the plain
reference's architecture aggregates over (its ``Model.a``), worked out
from the raw graph, times the same block in float64: ``y_gap``, the
largest ``|y - y_ref|`` over the largest ``|y_ref|`` of a request.  The
control is the same product in float32 with the matrix's values and the
block rounded to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import gc
import random
import statistics
import time
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

from h100bench import check, data, harness, loop, work
from h100bench import trace as tr
from h100bench.peaks import peaks_for
from h100bench.reference import gnn
from h100bench.timing import DeviceTimer

FAULTS = ()  # the planted faults patch aggregation and training, not plan.matmat


class Session(NamedTuple):
    pool: torch.Tensor  # [pool, n, k]


class SpmmPlan:
    """The seed-independent part of a cell: graph and admission."""

    def __init__(self, ctx):
        from repro_torch.graph.train import NodeClassifierTrainer
        from repro_torch.serving.registry import MatrixRegistry

        self.ctx, cfg, wl = ctx, ctx.config, ctx.workload
        prog = cfg["program"]
        self.device = ctx.device
        self.graph = data.rmat_graph(wl["graph"], self.device)
        csr = data.program_csr(self.graph)
        self.registry = MatrixRegistry(device=self.device, cache_dir=ctx.cache_dir("autotune"),
                                       search=False)
        convention = NodeClassifierTrainer(cfg["dims"], model=prog["model"], op=prog["op"],
                                           registry=self.registry)
        t = time.perf_counter()
        self.plan = self.registry.admit(convention.prepare_adjacency(csr))
        self.admit_s = time.perf_counter() - t

    def remake(self) -> None:
        """Nothing to remake: every request calls the plan."""

    def start(self, seed: int) -> Session:
        """The pool of blocks from ``seed``; the product warmed up."""
        wl = self.ctx.workload
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pool = data.features(gen, self.graph.n, wl["k"], count=wl["request_pool"])
        for i in range(wl["warmup_requests"]):
            self.plan.matmat(pool[i % len(pool)])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return Session(pool)

    def window(self, session: Session, seconds: float, trace: bool, seed: int):
        """The measured requests: the window, each request's ms, and the
        kept answers ``{request: (pool index, y)}``."""
        wl = self.ctx.workload
        timer = DeviceTimer(self.device)
        sample = set(random.Random(seed).sample(range(wl["sample_from"]), wl["sampled"]))
        times, kept, last = [], {}, {}
        pool = session.pool

        def request(i):
            j = i % len(pool)
            timer.start()
            if trace:
                with record_function(tr.AGG):
                    y = self.plan.matmat(pool[j])
            else:
                y = self.plan.matmat(pool[j])
            times.append(timer.stop())
            if i in sample:
                kept[i] = (j, y)
            last["y"] = (i, j, y)

        with torch.inference_mode():
            win = loop.closed_loop(request, seconds, trace)
        i, j, y = last["y"]
        kept[i] = (j, y)
        return win, times, kept

    def release(self) -> None:
        self.plan = self.registry = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, session: Session, kept: dict, precision: str) -> dict:
        """The reference's answer to each pool entry that ``kept`` names:
        float64, or float32 with the matrix and the block rounded to TF32."""
        cfg, g = self.ctx.config, self.graph
        dtype = "float64" if precision == "float64" else "float32"
        a = harness.arch_module("reference", cfg).Model(g.indptr, g.indices, g.values, g.n,
                                                        dtype).a
        if precision == "tf32":
            a = a._replace(values=gnn._tf32_round(a.values))
        out = {}
        for j in sorted({j for j, _ in kept.values()}):
            x = session.pool[j].to(a.values.dtype)
            out[j] = gnn.spmm_sum(a, gnn._tf32_round(x) if precision == "tf32" else x)
        return out

    def judge(self, session: Session, kept: dict, want: dict = None) -> dict:
        want = want or self.follow(session, kept, "float64")
        return {"y_gap": max(check.logits_gap(y, want[j]) for j, y in kept.values())}

    def control(self, session: Session, kept: dict, want: dict) -> dict:
        got = self.follow(session, kept, "tf32")
        return self.judge(session, {i: (j, got[j]) for i, (j, _) in kept.items()}, want)

    def work(self) -> work.Work:
        g = self.graph
        nnz = harness.arch_module("work", self.ctx.config).nnz(g)
        return work.spmm(g.n, g.n, nnz, self.ctx.workload["k"])


Cell = SpmmPlan


def readings(cell: SpmmPlan, seed: int, seconds: float, with_control: bool):
    """For the calibration: the program's numbers over a ``seconds`` window
    from ``seed``, and the control's (or None)."""
    session = cell.start(seed)
    _, _, kept = cell.window(session, seconds, False, seed)
    want = cell.follow(session, kept, "float64")
    got = cell.judge(session, kept, want)
    return got, cell.control(session, kept, want) if with_control else None, {}


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


def run(ctx) -> dict:
    cell = SpmmPlan(ctx)
    session = cell.start(ctx.seed)
    setup_s = time.perf_counter() - ctx.t0
    window, times, kept = cell.window(session, ctx.seconds, ctx.trace, ctx.seed)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    request = cell.work()
    layer = None
    if ctx.device.type == "cuda":
        peaks = peaks_for(torch.cuda.get_device_name(ctx.device))
        layer = loop.layer_inputs(window, request.bound_s(peaks), request.flops,
                                  peaks.fp32_flops, cell.admit_s)
    cell.release()
    return {
        "e2e": {"forward_ms": 1e3 * window.seconds / max(window.count, 1),
                "forward_p95_ms": p95(times), "setup_s": setup_s},
        "attempted": window.count,
        "failed": 0,
        "numbers": cell.judge(session, kept),
        "memory_peak_bytes": peak,
        "layer": layer,
        "summary": window.summary,
    }
