"""The port's spans as profiler ranges, and the benchmark's reduction of a
traced slice by them.

While a ``torch.profiler`` records, ``obs.span(name)`` opens a
``record_function`` range named ``repro_torch.<name>``, obs enabled or
not; while neither, it is the shared ``NOOP``.  A train step on the CPU
(a graph of a few hundred nodes) yields the trainer's phases and the
aggregation's forward and backward as nested ranges; an enabled span's
Tracer event lies on the profiler's clock; ``h100bench.spans.reduce``
reduces a hand-made event list by program range, which
``h100bench.trace.summarize`` reads as it always has.
"""
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.graph as tg
from h100bench import spans as hspans
from h100bench import trace as htrace
from repro_torch import obs
from repro_torch.graph.train import NodeClassifierTrainer
from repro_torch.obs.trace import PREFIX

N = 200
DIMS = [12, 16, 16, 6]


@pytest.fixture()
def clean_obs():
    obs.disable()
    obs.reset()
    yield obs
    obs.disable()
    obs.reset()


def _ranges(prof):
    """The program's ranges of a profile: ``[(name, start_ns, end_ns)]``,
    the prefix dropped."""
    return [(e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU]


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_noop_when_disabled_and_no_profiler_records(clean_obs):
    assert not torch.autograd._profiler_enabled()
    assert obs.span("train.step") is obs.NOOP
    with obs.span("train.step") as sp:
        assert sp.annotate(k=1) is obs.NOOP


@pytest.mark.parametrize("enabled", [False, True], ids=["obs-off", "obs-on"])
def test_span_is_one_prefixed_range_nested_in_its_parent(clean_obs, enabled):
    if enabled:
        obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            with obs.span("inner") as sp:
                sp.annotate(rows=3)  # admission sites annotate; a range takes it too
                torch.ones(4).add_(1)
    got = _ranges(prof)
    assert sorted(name for name, _, _ in got) == ["inner", "outer"]
    inner, outer = sorted(got, key=lambda r: r[0])
    assert _within(inner, outer) and inner[1] > outer[1]
    names = [ev["name"] for ev in obs.tracer().snapshot()]
    assert names == (["inner", "outer"] if enabled else [])


def _trainer_step(model, op):
    adj = tg.power_law_graph(N, 5.0, seed=3, symmetric=model == "gcn")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, DIMS[0])).astype(np.float32)
    labels = rng.integers(0, DIMS[-1], N)
    trainer = NodeClassifierTrainer(DIMS, model=model, op=op, device="cpu")
    agg = trainer.aggregator(trainer.prepare_adjacency(adj))
    state = trainer.init(0)
    state, _ = trainer.step(state, agg, x, labels)  # first step outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(state, agg, x, labels)
    return _ranges(prof)


@pytest.mark.parametrize("model,op,backward,unpermutes", [
    ("gcn", "sum", 3, 6),  # each layer's Â and Âᵀ products
    ("sage", "max", 2, 3),  # the first layer aggregates the input: no scatter
])
def test_train_step_yields_its_phases_and_aggregation_ranges(clean_obs, model, op, backward,
                                                             unpermutes):
    got = _trainer_step(model, op)
    count = {name: sum(1 for r in got if r[0] == name) for name in {r[0] for r in got}}
    layers = len(DIMS) - 1
    assert count == {"train.step": 1, "train.forward": 1, "train.backward": 1,
                     "train.adamw": 1, "train.host_read": 1, "gnn.forward": 1,
                     "agg.forward": layers, "agg.backward": backward,
                     "kernels.unpermute": unpermutes}
    first = {r[0]: r for r in reversed(got)}
    step = first["train.step"]
    assert all(_within(r, step) for r in got)
    for phase in ("train.backward", "train.adamw", "train.host_read"):
        assert first["train.forward"][2] <= first[phase][1]
    assert _within(first["gnn.forward"], first["train.forward"])
    for r in got:
        if r[0] == "agg.forward":
            assert _within(r, first["gnn.forward"])
        if r[0] == "agg.backward":
            assert _within(r, first["train.backward"])


def test_enabled_span_event_lies_on_the_profilers_clock(clean_obs):
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("clock"):
            time.sleep(0.003)
    (_, start_ns, end_ns), = _ranges(prof)
    (ev,) = obs.tracer().snapshot()
    assert abs(ev["ts"] - start_ns / 1e3) < 1e3  # both in µs since the Unix epoch
    assert abs(ev["ts"] + ev["dur"] - end_ns / 1e3) < 1e3
    assert abs(ev["ts"] / 1e6 - time.time()) < 60


def test_no_module_outside_obs_opens_profiler_ranges():
    root = Path(tg.__file__).resolve().parents[1]
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function" in p.read_text() and p.parent.name != "obs")
    assert users == []


class _Event:
    """What ``summarize`` reads of one raw profiler event."""

    def __init__(self, name, t0, t1, thread=1, corr=0, device=False, annotation=False):
        self._name, self._t0, self._t1 = name, t0, t1
        self._thread, self._corr, self._device, self._annotation = thread, corr, device, annotation

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation


def _slice():
    """A step on thread 1 whose backward launches from thread 2, with a
    gap inside ``train.host_read`` and two inside no program range."""
    P = PREFIX
    return [
        _Event(htrace.WINDOW, 0, 1000),
        _Event(P + "train.step", 100, 800),
        _Event(P + "train.forward", 110, 300),
        _Event(htrace.AGG, 140, 260),
        _Event(P + "agg.forward", 150, 250),
        _Event(P + "train.backward", 300, 600),
        _Event(htrace.AGG_BWD, 340, 510, thread=2),
        _Event(P + "agg.backward", 350, 500, thread=2),
        _Event(P + "train.host_read", 600, 790),
        _Event("cudaLaunchKernel", 50, 55, corr=3),  # before the step
        _Event("cudaLaunchKernel", 160, 170, corr=1),
        _Event("cudaLaunchKernel", 400, 410, thread=2, corr=2),
        _Event("cudaMemcpyAsync", 650, 655, corr=5),
        _Event("cudaStreamSynchronize", 700, 780, corr=4),
        _Event("k3", 60, 90, device=True, corr=3),
        _Event("k1", 200, 280, device=True, corr=1),
        _Event(P + "agg.forward", 200, 280, device=True, annotation=True),  # its mirror
        _Event("k2", 420, 560, device=True, corr=2),
        _Event("Memcpy DtoH", 660, 680, device=True, corr=5),
    ]


def test_summarize_reduces_a_slice_by_program_range():
    events = _slice()
    s = htrace.summarize(events)
    # what the harness reads: busy 30 + 80 + 140 + 20 ns, aggregation
    # k1 + k2, the gaps labelled by the innermost host range of any kind
    assert (s.window_s, s.busy_s, s.agg_device_s) == (1e-6, 270e-9, 220e-9)
    assert (s.device_count, s.unlaunched) == (4, 0)
    assert s.idle_gaps == [["(no host range)", 380e-9], [PREFIX + "agg.backward", 140e-9],
                           [htrace.AGG, 110e-9], [PREFIX + "train.host_read", 100e-9]]
    spans = hspans.reduce(events)
    by = spans.by_name
    assert set(by) == {"train.step", "train.forward", "agg.forward", "train.backward",
                       "agg.backward", "train.host_read"}
    assert by["train.step"] == hspans.SpanStats(1, 100e-9, 0.0, 2, 1)  # k2's launch any thread
    assert by["agg.forward"] == hspans.SpanStats(1, 80e-9, 0.0, 1, 0)
    assert by["train.forward"] == hspans.SpanStats(1, 80e-9, 110e-9, 1, 0)
    assert by["agg.backward"] == hspans.SpanStats(1, 140e-9, 140e-9, 1, 0)
    assert by["train.backward"] == hspans.SpanStats(1, 0.0, 0.0, 1, 0)
    assert by["train.host_read"] == hspans.SpanStats(1, 20e-9, 100e-9, 0, 1)
    assert (spans.window_s, spans.unspanned_idle_s) == (1e-6, 380e-9)


def test_readers_of_the_program_ranges():
    spans = hspans.reduce(_slice())
    want = {"agg_fwd_ms.train": 80e-6, "agg_bwd_ms.train": 140e-6, "read_idle.train": 10.0,
            "unspanned_idle.train": 38.0, "launches.train": 2.0, "syncs.train": 1.0}
    got = hspans.readings(spans, 1)
    assert got == pytest.approx(want, rel=1e-12)  # no unpermute range in the slice
    assert hspans.readings(spans, 2)["launches.train"] == 1.0
    assert hspans.readings(spans, 0) == {}
    forward = spans._replace(by_name={"gnn.forward": hspans.SpanStats(1, 0.0, 0.0, 3, 0),
                                      "kernels.unpermute": hspans.SpanStats(2, 1e-6, 0.0, 1, 0)})
    assert hspans.readings(forward, 1) == pytest.approx(
        {"unpermute_ms.infer": 1e-3, "unspanned_idle.infer": 38.0, "launches.infer": 3.0})
    bare = spans._replace(by_name={}, unspanned_idle_s=1e-6)  # a program without ranges
    assert hspans.readings(bare, 1) == {}
    no_window = [e for e in _slice() if e.name() != htrace.WINDOW]
    with pytest.raises(RuntimeError):
        hspans.reduce(no_window)
