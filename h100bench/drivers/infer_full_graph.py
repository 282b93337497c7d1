"""Full-graph forwards, one after another, under ``torch.inference_mode()``
through the program's ``GCN`` / ``GraphSAGE`` modules over
``plan_aggregator`` of a registry plan.

Set-up builds the graph, admits the model's adjacency (the program's own
convention, ``NodeClassifierTrainer.prepare_adjacency`` of the
configuration's ``program`` ``model``: GCN's ``Â``, SAGE's raw ``A``),
loads the seed's weights into the module the configuration's ``program``
names and warms the forward up.  Each forward of the window takes the
next of a pool of feature matrices drawn from the seed, and is timed on
the device's clock from its issue to a ``torch.cuda.synchronize()``.  The
outputs of a few forwards drawn from the seed, and the last one, are kept
and compared with the plain reference once the window has closed.
"""
from __future__ import annotations

import gc
import random
import statistics
import time
from typing import NamedTuple

import torch

from h100bench import check, data, harness, loop, work
from h100bench.peaks import peaks_for
from h100bench.timing import DeviceTimer

FAULTS = ("half_batch", "altered")  # a forward has no state to leave unchanged


class Session(NamedTuple):
    pool: torch.Tensor  # [pool, n, features]
    params0: list
    model: object  # the program's module


class Infer:
    """The seed-independent part of a cell: graph and admission."""

    def __init__(self, ctx):
        from repro_torch.graph import plan_aggregator
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
        adj = convention.prepare_adjacency(csr)
        self.agg = plan_aggregator(self.registry.admit(adj), op=prog["op"])
        self.admit_s = time.perf_counter() - t

    def remake(self) -> None:
        """Nothing to remake: the aggregator calls the plan at each forward."""

    def start(self, seed: int) -> Session:
        """Feature pool and weights from ``seed``; the forward warmed up."""
        import repro_torch.graph

        cfg, wl = self.ctx.config, self.ctx.workload
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pool = data.features(gen, self.graph.n, cfg["dims"][0], count=wl["feature_pool"])
        params0 = data.weights(gen, cfg["dims"], cfg["weight_fields"], cfg["bias_std"])
        module = getattr(repro_torch.graph, cfg["program"]["module"])
        model = module.from_params([[t.cpu().numpy() for t in p] for p in params0],
                                   device=self.device)
        with torch.inference_mode():
            for i in range(wl["warmup_forwards"]):
                model(self.agg, pool[i % len(pool)])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return Session(pool, params0, model)

    def window(self, session: Session, seconds: float, trace: bool, seed: int):
        """The measured forwards: the window, each forward's ms, and the
        kept outputs ``{forward: (pool index, logits)}``."""
        from h100bench import trace as tr

        wl = self.ctx.workload
        agg = tr.traced_aggregator(self.agg) if trace else self.agg
        timer = DeviceTimer(self.device)
        sample = set(random.Random(seed).sample(range(wl["sample_from"]), wl["sampled"]))
        times, kept, last = [], {}, {}
        pool = session.pool

        def forward(i):
            j = i % len(pool)
            timer.start()
            out = session.model(agg, pool[j])
            times.append(timer.stop())
            if i in sample:
                kept[i] = (j, out)
            last["out"] = (i, j, out)

        with torch.inference_mode():
            win = loop.closed_loop(forward, seconds, trace)
        i, j, out = last["out"]
        kept[i] = (j, out)
        return win, times, kept

    def release(self, session: Session) -> Session:
        self.agg = self.registry = None
        session = session._replace(model=None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return session

    def judge(self, session: Session, kept: dict, want: dict = None) -> dict:
        """The kept outputs against the reference's logits (float64)."""
        want = want or self.follow(session, kept, "float64")
        gaps = [check.logits_gap(out, want[j]) for j, out in kept.values()]
        return {"logits_gap": max(gaps)}

    def follow(self, session: Session, kept: dict, precision: str) -> dict:
        """The reference's logits of each pool entry that ``kept`` names."""
        cfg, g = self.ctx.config, self.graph
        model = harness.arch_module("reference", cfg).Model(g.indptr, g.indices, g.values, g.n,
                                                            precision)
        return {j: model.logits(session.params0, session.pool[j])
                for j in sorted({j for j, _ in kept.values()})}

    def control(self, session: Session, kept: dict, want: dict) -> dict:
        """The reference in TF32, put in the program's place."""
        got = self.follow(session, kept, "tf32")
        return self.judge(session, {i: (j, got[j]) for i, (j, _) in kept.items()}, want)

    def work(self):
        cfg, g = self.ctx.config, self.graph
        counts = harness.arch_module("work", cfg)
        return counts.step_work(cfg["dims"], g.n, counts.nnz(g), train=False)


Cell = Infer


def readings(cell: Infer, seed: int, seconds: float, with_control: bool):
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
    cell = Infer(ctx)
    session = cell.start(ctx.seed)
    setup_s = time.perf_counter() - ctx.t0
    window, times, kept = cell.window(session, ctx.seconds, ctx.trace, ctx.seed)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    steps = cell.work()
    layer = None
    if ctx.device.type == "cuda":
        peaks = peaks_for(torch.cuda.get_device_name(ctx.device))
        layer = loop.layer_inputs(
            window, work.bound_s(steps["aggregation"], peaks),
            work.total(steps["aggregation"] + steps["dense"]).flops, peaks.fp32_flops,
            cell.admit_s)
    session = cell.release(session)
    numbers = cell.judge(session, kept)
    return {
        "e2e": {"forward_ms": 1e3 * window.seconds / max(window.count, 1),
                "forward_p95_ms": p95(times), "setup_s": setup_s},
        "attempted": window.count,
        "failed": 0,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "layer": layer,
        "summary": window.summary,
    }
