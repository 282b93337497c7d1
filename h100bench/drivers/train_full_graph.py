"""Full-batch training steps, one after another, through the program's
``NodeClassifierTrainer.step`` with the registry-served aggregator.

Set-up builds the graph, admits it (the trainer's ``prepare_adjacency``
and ``aggregator``: ``admit_pair``, or ``admit`` where the backward needs
no transpose), carries the seed's weights into one train state, and drives
that state through the checked steps and the warm-up steps; the window
then continues from it.  Every step ends in the trainer's own host read
of its loss.  Once the window has closed and the program is freed, the
plain reference follows the checked steps from the same weights and
inputs.  The configuration's ``program`` names the trainer's ``model``
and ``op``, its ``weight_fields`` the tensors of a layer, and its
``arch`` the reference and the work counts.
"""
from __future__ import annotations

import gc
import math
import time
from typing import NamedTuple

import torch

from h100bench import check, data, harness, loop, work
from h100bench.faults import FAULTS
from h100bench.peaks import peaks_for
from h100bench.reference import gnn as ref


class Session(NamedTuple):
    x: torch.Tensor
    labels: torch.Tensor
    params0: list  # tuples per layer, as the benchmark drew them
    losses: list  # the checked steps' losses
    first_grads: list  # step 1's gradient before clipping, from the optimizer's moment
    first_norm: float  # its global norm, as the step reported it
    params: list  # the leaves after the checked steps
    state: object  # the train state the window continues from


class Train:
    """The seed-independent part of a cell: graph, admission, trainer."""

    def __init__(self, ctx):
        from repro_torch.graph.train import NodeClassifierTrainer
        from repro_torch.optim import AdamWConfig
        from repro_torch.serving.registry import MatrixRegistry

        self.ctx, cfg, wl = ctx, ctx.config, ctx.workload
        self.device = ctx.device
        self.graph = data.rmat_graph(wl["graph"], self.device)
        self.csr = data.program_csr(self.graph)
        self.registry = MatrixRegistry(device=self.device, cache_dir=ctx.cache_dir("autotune"),
                                       search=False)
        self.trainer = NodeClassifierTrainer(
            cfg["dims"], model=cfg["program"]["model"], op=cfg["program"]["op"],
            adamw=AdamWConfig(**cfg["adamw"]), registry=self.registry)
        self.admit_s = self.remake()

    def remake(self) -> float:
        """The trainer's adjacency admitted and its aggregator made; the
        seconds it took (a second call finds the plan resident)."""
        t = time.perf_counter()
        self.agg = self.trainer.aggregator(self.trainer.prepare_adjacency(self.csr))
        return time.perf_counter() - t

    def start(self, seed: int) -> Session:
        """Inputs and weights from ``seed``, carried into a fresh state and
        driven through the checked steps and the warm-up steps."""
        cfg, wl = self.ctx.config, self.ctx.workload
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = data.features(gen, self.graph.n, cfg["dims"][0])
        labels = data.labels(gen, x, cfg["dims"][-1])
        params0 = data.weights(gen, cfg["dims"], cfg["weight_fields"], cfg["bias_std"])
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
        return Session(x, labels, params0, losses, first, norm, params, state)

    def window(self, session: Session, seconds: float, trace: bool):
        """The measured steps; returns the window and the non-finite losses."""
        from h100bench import trace as tr

        agg = tr.traced_aggregator(self.agg) if trace else self.agg
        box = {"state": session.state, "failed": 0}

        def step(_):
            box["state"], out = self.trainer.step(box["state"], agg, session.x, session.labels)
            box["failed"] += not math.isfinite(out["loss"])

        return loop.closed_loop(step, seconds, trace), box["failed"]

    def release(self) -> None:
        """Free the program's state and its device memory."""
        self.agg = self.trainer = self.registry = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, session: Session, precision: str) -> ref.TrainTrace:
        """The reference's own checked steps from the session's start."""
        cfg, g = self.ctx.config, self.graph
        model = harness.arch_module("reference", cfg).Model(g.indptr, g.indices, g.values, g.n,
                                                            precision)
        return ref.train(model, session.params0, session.x, session.labels, cfg["adamw"],
                         self.ctx.workload["checked_steps"])

    def judge(self, session: Session, want: ref.TrainTrace = None) -> dict:
        """The program's checked steps against the reference's (float64):
        each step's loss gap, each leaf's gradient and change gap."""
        want = want or self.follow(session, "float64")
        leaves0 = [t for p in session.params0 for t in p]
        return check.train_detail(session.losses, session.first_grads, session.first_norm,
                                  session.params, want, leaves0,
                                  self.ctx.config["adamw"]["grad_clip"])

    def control(self, session: Session, want: ref.TrainTrace) -> dict:
        """The reference in TF32, put in the program's place: its gaps."""
        got = self.follow(session, "tf32")
        leaves0 = [t for p in session.params0 for t in p]
        return check.train_detail(got.losses, got.first_grads, got.first_norm, got.params, want,
                                  leaves0, self.ctx.config["adamw"]["grad_clip"])

    def work(self):
        cfg, g = self.ctx.config, self.graph
        counts = harness.arch_module("work", cfg)
        return counts.step_work(cfg["dims"], g.n, counts.nnz(g), train=True)


Cell = Train


def readings(cell: Train, seed: int, seconds: float, with_control: bool):
    """For the calibration: the program's numbers from ``seed``, the
    control's (or None) and the per-leaf detail of both."""
    session = cell.start(seed)
    want = cell.follow(session, "float64")
    got = cell.judge(session, want)
    ctrl = cell.control(session, want) if with_control else None
    head = len(session.params0[-1])
    return (check.train_numbers(got, head),
            check.train_numbers(ctrl, head) if ctrl is not None else None,
            {"program_detail": got, "control_detail": ctrl})


def run(ctx) -> dict:
    cell = Train(ctx)
    session = cell.start(ctx.seed)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0
    window, failed = cell.window(session, ctx.seconds, ctx.trace)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    steps = cell.work()
    peaks = peaks_for(torch.cuda.get_device_name(ctx.device)) if ctx.device.type == "cuda" \
        else None
    layer = None
    if peaks is not None:
        layer = loop.layer_inputs(
            window, work.bound_s(steps["aggregation"], peaks),
            work.total(steps["aggregation"] + steps["dense"]).flops, peaks.fp32_flops,
            cell.admit_s)
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
