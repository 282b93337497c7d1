"""The port's dry run (``repro_torch.launch.dryrun``) and its readers.

* ``parse_collective_bytes`` and ``roofline_from_costs`` agree exactly with
  the JAX package's on the same HLO text and costs (every collective kind,
  both ``replica_groups`` formats, tuple results, async start/done pairs,
  nested ``while`` loops with and without ``known_trip_count``), the JAX
  package's ``V5E`` passed to both.
* ``load``, ``roofline_table`` and ``dryrun_table`` give the JAX package's
  strings for the same synthetic records; ``fleet_stats`` too, apart from
  the memory it reads from the records.
* A cell of OLMo-1B at full width on the single-pod mesh, traced on fake
  CPU tensors: ``train_4k`` reaches ``ok`` with the argument bytes of its
  specs, a peak at least those, and 6 N tokens of model FLOPs;
  ``long_500k`` is skipped with the JAX package's reason; the CLI writes
  both meshes' records.
* The trace itself, at a small size: on fake tensors it reads the same
  peak as the same tracker over the same step on real CPU tensors, and
  the same FLOPs as ``FlopCounterMode``; on the 1x1 host mesh the argument
  bytes are the real ones.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.analysis.report as jreport
import repro.analysis.roofline as jroof
from repro_torch.analysis import report as treport
from repro_torch.analysis import roofline as troof
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models import params as tparams
from repro_torch.optim import AdamWConfig, opt_state_specs
from repro_torch.optim.adamw import QTensor, init_opt_state

HLO = """HloModule jit_train_step, entry_computation_layout={(f32[4]{0})->f32[4]{0}}

%add.0 (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%region_body.1 (arg: (s32[], bf16[8,128])) -> (s32[], bf16[8,128]) {
  %p = (s32[], bf16[8,128]) parameter(0)
  %ag = bf16[16,128]{1,0} all-gather(bf16[8,128]{1,0} %x), channel_id=1, replica_groups={{0,1},{2,3}}, dimensions={0}
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %y), channel_id=2, replica_groups=[32,16]<=[512], to_apply=%add.0
  ROOT %t = (s32[], bf16[8,128]) tuple(s32[] %i, bf16[8,128] %x)
}

%inner_body.2 (arg: (s32[], f32[4])) -> (s32[], f32[4]) {
  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %z), channel_id=3, replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add.0
  %a2a = (bf16[4,8]{1,0}, bf16[4,8]{1,0}) all-to-all(bf16[4,8]{1,0} %a, bf16[4,8]{1,0} %b), channel_id=4, replica_groups={{0,1,2,3}}
  ROOT %t = (s32[], f32[4]) tuple(s32[] %i, f32[4] %v)
}

%outer_body.3 (arg: (s32[], f32[4])) -> (s32[], f32[4]) {
  %w = (s32[], f32[4]) while((s32[], f32[4]) %init), condition=%cond.4, body=%inner_body.2, backend_config={"known_trip_count":{"n":"4"}}
  %cp = f32[256]{0} collective-permute(f32[256]{0} %q), channel_id=5, source_target_pairs={{0,1},{1,0}}
  ROOT %t = (s32[], f32[4]) tuple(s32[] %i, f32[4] %v)
}

%free_body.5 (arg: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ar2 = bf16[2,64]{1,0} all-reduce(bf16[2,64]{1,0} %u), channel_id=6, replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add.0
  ROOT %t = (s32[], f32[4]) tuple(s32[] %i, f32[4] %v)
}

ENTRY %main.6 (p0: f32[4]) -> f32[4] {
  %w1 = (s32[], bf16[8,128]) while((s32[], bf16[8,128]) %i1), condition=%cond.7, body=%region_body.1, backend_config={"known_trip_count":{"n":"16"}}
  %w2 = (s32[], f32[4]) while((s32[], f32[4]) %i2), condition=%cond.8, body=%outer_body.3, backend_config={"known_trip_count":{"n":"3"}}
  %w3 = (s32[], f32[4]) while((s32[], f32[4]) %i3), condition=%cond.9, body=%free_body.5
  %ars = f32[2048]{0} all-reduce-start(f32[2048]{0} %g), channel_id=7, replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add.0
  %ard = f32[2048]{0} all-reduce-done(f32[2048]{0} %ars)
  %agu = bf16[512]{0} all-gather(bf16[32]{0} %h), channel_id=8, dimensions={0}
  %tup = (f32[16]{0}, s32[8]{0}) all-reduce(f32[16]{0} %m, s32[8]{0} %n), channel_id=9, replica_groups={{0,1}}, to_apply=%add.0
  %pred = pred[32]{0} collective-permute(pred[32]{0} %pp), channel_id=10, source_target_pairs={{0,1}}
  ROOT %r = f32[4]{0} copy(f32[4]{0} %p0)
}
"""


@pytest.mark.parametrize("world,default_trip", [(512, 1), (256, 1), (512, 5), (16, 2)])
def test_parse_collective_bytes_matches_jax(world, default_trip):
    got = troof.parse_collective_bytes(HLO, world=world, default_trip=default_trip)
    want = jroof.parse_collective_bytes(HLO, world=world, default_trip=default_trip)
    assert got == want
    total, by_kind = got
    assert all(v > 0 for v in by_kind.values()), by_kind  # every kind is in the text
    assert total == pytest.approx(sum(by_kind.values()))


def test_parse_collective_helpers_match_jax():
    for s in ("bf16[8,128]", "f32[]", "pred[3]", "c128[2,2]", "weird[4]", "nothing"):
        assert troof._shape_bytes(s) == jroof._shape_bytes(s)
    for line in ("x replica_groups={{0,1,2}}", "x replica_groups=[32,16]<=[512]", "x"):
        assert troof._group_size(line, 64) == jroof._group_size(line, 64)
    for kind in jroof._COLLECTIVES + ("send",):
        for g in (1, 2, 16):
            assert troof._wire_bytes(kind, 1000.0, g) == jroof._wire_bytes(kind, 1000.0, g)
    assert troof._split_computations(HLO) == jroof._split_computations(HLO)


def test_roofline_from_costs_matches_jax():
    c1 = {"flops": 3.0e12, "bytes accessed": 7.5e10, "other": 1.0}
    c2 = {"flops": 5.5e12, "bytes accessed": 9.0e10}
    hw = jroof.V5E  # the JAX package's spec, passed to both
    for n_groups in (1, 2, 16, 96):
        for coll in (0.0, 3.2e9):
            got = troof.roofline_from_costs(c1, c2, n_groups, coll, hw)
            want = jroof.roofline_from_costs(c1, c2, n_groups, coll, hw)
            assert got.as_dict() == want.as_dict()
            assert got.t_bound == want.t_bound
    # a negative extrapolation is floored at zero in both
    assert troof.roofline_from_costs({"flops": 9.0}, {"flops": 1.0}, 4, 0.0, hw).flops == 0.0


def test_h100_specs_carry_the_bf16_rate():
    assert troof.H100_SXM.bf16_flops == 989e12 and troof.H200.bf16_flops == 989e12
    assert troof.H100_PCIE.bf16_flops == 756e12 and troof.H100_NVL.bf16_flops == 835e12
    assert troof.H100_SXM.peak_flops == 67e12  # f32, the HBP kernels' rate


def _records(hbm=16e9):
    """Synthetic dry-run records: ok (with and without a roofline),
    skipped, error, and cells missing altogether."""
    recs = {}

    def ok(arch, shape, mesh, peak, fits, **extra):
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
               "compile_s": 1.25, "fits_hbm": fits,
               "memory": {"peak_estimate_bytes": peak, "hbm_bytes": hbm}, **extra}
        recs[arch, shape, mesh] = rec

    roof = {"t_compute_s": 0.0123, "t_memory_s": 2.5, "t_collective_s": 0.5,
            "bottleneck": "memory"}
    ok("olmo-1b", "train_4k", "single", 9.7e9, True, n_microbatch=2, roofline=roof,
       model_flops_ratio=0.81)
    ok("olmo-1b", "train_4k", "multipod", 5.1e9, True, n_microbatch=1)
    ok("olmo-1b", "decode_32k", "single", 2.3e9, True,
       roofline=dict(roof, t_memory_s=0.011, bottleneck="memory"), model_flops_ratio=None)
    ok("nemotron-4-340b", "train_4k", "single", 3.1e10, False, n_microbatch=16,
       roofline=dict(roof, t_compute_s=4.0, bottleneck="compute"), model_flops_ratio=1.02)
    for mesh in ("single", "multipod"):
        recs["olmo-1b", "long_500k", mesh] = {"arch": "olmo-1b", "shape": "long_500k",
                                              "mesh": mesh, "status": "skipped",
                                              "reason": "full attention"}
    recs["jamba-1.5-large-398b", "prefill_32k", "single"] = {
        "arch": "jamba-1.5-large-398b", "shape": "prefill_32k", "mesh": "single",
        "status": "error", "error": "RuntimeError: x"}
    return recs


def test_report_tables_match_jax(tmp_path):
    recs = _records()
    for (arch, shape, mesh), r in recs.items():
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(r))
    assert treport.load(tmp_path) == jreport.load(tmp_path) == recs
    assert treport.ARCH_ORDER == jreport.ARCH_ORDER
    assert treport.SHAPE_ORDER == jreport.SHAPE_ORDER
    assert treport.roofline_table(recs) == jreport.roofline_table(recs)
    assert treport.dryrun_table(recs) == jreport.dryrun_table(recs)
    for x in (0.0004, 0.5, 1.0, 12.345):
        assert treport.fmt_s(x) == jreport.fmt_s(x)
    # the budget comes from the records: 16e9 bytes reads as the JAX
    # package's line; the card's memory reads as itself
    assert treport.fleet_stats(recs) == jreport.fleet_stats(recs)
    card = _records(hbm=85_029_158_912)
    assert treport.fleet_stats(card) == jreport.fleet_stats(card).replace(
        "16 GB/chip", "85.0292 GB/chip")


def test_report_cli_renders_the_tables(tmp_path, capsys):
    recs = _records()
    for (arch, shape, mesh), r in recs.items():
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(r))
    treport.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert treport.roofline_table(recs) in out and treport.dryrun_table(recs) in out
    assert treport.fleet_stats(recs) in out


# --- the trace -----------------------------------------------------------------


def _spec_bytes(tree, specs, mesh):
    sizes = tparams.mesh_shape(mesh)
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        elif isinstance(t, QTensor):
            walk(t.q, s.q)
            walk(t.scale, s.scale)
        else:
            axes = [a for e in s if e is not None for a in ((e,) if isinstance(e, str) else e)]
            total += t.numel() * t.element_size() // math.prod(sizes[a] for a in axes)

    walk(tree, specs)
    return total


@pytest.fixture(scope="module")
def olmo_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {shape: dryrun.run_cell("olmo-1b", shape, "single", out, hw=troof.H100_SXM,
                                   device="cpu") for shape in ("train_4k", "long_500k")}
    return out, recs


def test_olmo_train_cell_is_ok(olmo_cells):
    out, recs = olmo_cells
    rec = recs["train_4k"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert json.loads((out / "olmo-1b__train_4k__single.json").read_text()) == json.loads(
        json.dumps(rec))
    cfg, shape, mesh = get_config("olmo-1b"), SHAPES["train_4k"], dryrun.MESHES["single"]
    assert rec["rules"] == "fsdp_tp" and rec["opt_state"] == "float32"
    assert rec["n_microbatch"] == dryrun.default_microbatch(cfg, shape, mesh, troof.H100_SXM)
    model = build_model(cfg)
    specs = model.specs(tparams.TRAIN_RULES, mesh)
    params = model.abstract()
    ocfg = AdamWConfig()
    want = _spec_bytes(params, specs, mesh) + _spec_bytes(
        init_opt_state(params, ocfg), opt_state_specs(params, specs, ocfg, mesh), mesh)
    want += shape.global_batch // 16 * shape.seq_len * 8  # int64 tokens over "data"
    mem = rec["memory"]
    assert mem["argument_bytes"] == want
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                          + mem["temp_bytes"] - mem["alias_bytes"])
    assert rec["fits_hbm"] == (mem["peak_estimate_bytes"] <= mem["hbm_bytes"] == 80e9)
    tokens = shape.global_batch * shape.seq_len
    assert rec["model_flops_global"] == 6 * cfg.active_param_count() * tokens
    assert 0 < rec["model_flops_ratio"] < 2
    assert rec["cost_analysis"]["flops"] > 0 and rec["cost_analysis"]["bytes accessed"] > 0
    coll = rec["collectives"]
    assert coll["wire_bytes_per_device"] == pytest.approx(sum(coll["by_kind"].values()))
    assert coll["by_kind"]["all-gather"] > 0 and coll["by_kind"]["reduce-scatter"] > 0
    assert coll["by_kind"]["all-reduce"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert len(rec["unrolled_costs"]) == 2


def test_olmo_long_context_cell_is_skipped(olmo_cells):
    _, recs = olmo_cells
    rec = recs["long_500k"]
    assert rec["status"] == "skipped"
    assert rec["reason"] == dryrun.cell_applicable(get_config("olmo-1b"), SHAPES["long_500k"])
    assert "pure full-attention" in rec["reason"]


def test_cli_writes_both_meshes_and_skips_done(tmp_path, capsys):
    args = ["--arch", "olmo-1b", "--shape", "long_500k", "--mesh", "both", "--out", str(tmp_path)]
    dryrun.main(args)
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["olmo-1b__long_500k__multipod.json", "olmo-1b__long_500k__single.json"]
    assert capsys.readouterr().out.count("SKIP") == 2
    dryrun.main(args + ["--skip-done"])
    assert capsys.readouterr().out == ""


def test_a_failing_cell_is_recorded(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("no trace")

    monkeypatch.setattr(dryrun, "dryrun_cell", boom)
    rec = dryrun.run_cell("olmo-1b", "decode_32k", "single", tmp_path, hw=troof.H100_SXM,
                          device="cpu")
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: no trace"
    assert json.loads((tmp_path / "olmo-1b__decode_32k__single.json").read_text())[
        "status"] == "error"


def _small():
    return dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=2, vocab=256)


def test_fake_trace_reads_the_real_peak_and_flops():
    """The same train step, traced on fake tensors and run on real ones
    under the same tracker: the same peak, the same FLOPs as
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train import make_train_step

    cfg = _small()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
    mesh = dryrun.MESHES["host"]
    fake, step, args, info = dryrun._build(cfg, shape, mesh, tparams.TRAIN_RULES, troof.H100_SXM,
                                           "cpu", 2, AdamWConfig())
    traced = dryrun._trace(fake, step, args, info["charge"])

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": init_opt_state(params, AdamWConfig())}
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32))}
    tracker = dryrun.LiveBytes()
    for t in dryrun._tensors((state, batch)):
        tracker.track(t)
    assert tracker.live == traced["args"] == info["argument_bytes"]
    real_step = make_train_step(model, AdamWConfig(), n_microbatch=2, remat=True)
    with tracker:
        real_step(state, batch)
    assert tracker.peak == traced["peak"]
    assert tracker.flops == traced["flops"] > 0
    with FlopCounterMode(display=False) as fc:
        real_step(state, batch)
    assert fc.get_total_flops() == traced["flops"]


def test_device_config_divides_the_model_axis():
    mesh = dryrun.MESHES["single"]
    cfg = get_config("llava-next-34b")  # 56 heads padded to 64, 8 KV heads
    local = dryrun.device_config(cfg, tparams.TRAIN_RULES, mesh)
    assert (local.padded_heads, local.n_kv_heads) == (4, 1)
    assert local.resolved_head_dim == cfg.resolved_head_dim
    assert local.d_ff == cfg.d_ff // 16 and local.padded_vocab == cfg.padded_vocab // 16
    jamba = dryrun.device_config(get_config("jamba-1.5-large-398b"), tparams.TRAIN_RULES, mesh)
    assert jamba.ssm_inner == get_config("jamba-1.5-large-398b").ssm_inner // 16
    assert jamba.moe_experts == get_config("jamba-1.5-large-398b").moe_experts
    assert dryrun.device_config(cfg, tparams.TRAIN_RULES, dryrun.MESHES["host"]) is cfg
    # one device's program builds, and its parameters are 1/16 of the
    # model-sharded ones
    full, part = build_model(cfg), build_model(local)
    wq = full.abstract()["dec"]["stack"]["l0"]["attn"]["wq"]
    assert part.abstract()["dec"]["stack"]["l0"]["attn"]["wq"].numel() * 16 == wq.numel()


def test_host_mesh_argument_bytes_are_the_real_ones():
    cfg = _small()
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64, global_batch=2)
    rec = dryrun.dryrun_cell(cfg, shape, dryrun.MESHES["host"], hw=troof.H100_SXM,
                             device="cpu", roofline=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(2, 64, device="cpu")
    real = sum(t.nbytes for t in dryrun._tensors((params, cache))) + 2 * 1 * 8  # tokens [2, 1]
    assert rec["memory"]["argument_bytes"] == real
    # the decode step writes the cache in place: it is all alias
    assert rec["memory"]["alias_bytes"] == sum(t.nbytes for t in dryrun._tensors(cache))
    assert rec["collectives"]["wire_bytes_per_device"] == 0
    assert np.isfinite(rec["memory"]["temp_bytes"]) and rec["memory"]["temp_bytes"] >= 0
