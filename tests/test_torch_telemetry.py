"""The port's telemetry readers against the JAX package's on the same snapshots.

Three snapshot dicts go through both packages: one dumped by the JAX
package's serving engine on the CPU, one by the port's engine on the CPU
(``device="cpu"``), and one built by hand (two plans, a row with no
measured seconds, autotune provenance, spans and a request log).  With an
equal :class:`HardwareSpec` passed to both, the attribution rows, their
table, the dashboard, the explain report and the diff must be equal —
rows as dicts, text character for character (the dashboard's title names
its own package).  The OpenMetrics exporter must render what the JAX
package's renders for the same metrics, parse back to the values it
rendered, and serve them from a loopback endpoint on port 0.  The card's
peak rates come from ``spec_for``, which raises on an unknown part, and
with ``hw=None`` and no card every reader raises.
"""
import dataclasses
import importlib
import json
import urllib.request

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.matrices as jmat
import repro.serving as jserving
from repro import obs as jobs
from repro.analysis import diff as jdiff
from repro.analysis import roofline as jroof
from repro.obs import attribution as jattr
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import planview as jplan
import repro_torch.core as tcore
import repro_torch.core.matrices as tmat
import repro_torch.serving as tserving
from repro_torch import obs as tobs
from repro_torch.analysis import diff as tdiff
from repro_torch.analysis import report as tcli
from repro_torch.analysis import roofline as troof
from repro_torch.obs import attribution as tattr
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import planview as tplan

# the dashboard modules (each package's ``obs.report`` is a function)
jreport = importlib.import_module("repro.obs.report")
treport = importlib.import_module("repro_torch.obs.report")

SMALL = dict(row_block=64, col_block=128, group=8, lane=16)

# one spec, in each package's type
HW = troof.H100_SXM
# (the port's spec also carries a bf16 rate, which the JAX package's lacks)
JHW = jroof.HardwareSpec(**{f.name: getattr(HW, f.name)
                            for f in dataclasses.fields(jroof.HardwareSpec)})
# the spec the JAX package's dashboard renders against (it takes no hw=)
JAX_DEFAULT = troof.HardwareSpec(**dataclasses.asdict(jroof.V5E))


def _mats(m):
    return {
        "A": m.circuit(150, seed=1, n_dense_rows=2, dense_row_frac=0.05),
        "B": m.banded_fem(130, seed=3, band=4, fill=0.9),
    }


def _stream(n_cols, n=17, seed=7):
    rng = np.random.default_rng(seed)
    return [("B" if i % 3 == 2 else "A", rng.standard_normal(n_cols).astype(np.float32))
            for i in range(n)]


def _engine_snapshot(obs, serving, core, mats, tmp_path, **reg_kw):
    """Admit both matrices, serve a mixed-k stream with ``obs`` enabled and
    return the collected snapshot as its JSON dump reads back."""
    obs.reset()
    obs.enable()
    try:
        reg = serving.MatrixRegistry(cache_dir=tmp_path, search=False, **reg_kw)
        for key, csr in mats.items():
            reg.admit(csr, key, cfg=core.PartitionConfig(**SMALL))
        clock = [0.0]
        eng = serving.ServingEngine(reg, max_batch=8, max_wait_s=0.01, clock=lambda: clock[0])
        tickets = []
        for i, (key, x) in enumerate(_stream(mats["A"].shape[1])):
            tickets.append(eng.submit(key, x[: mats[key].shape[1]]))
            if i % 5 == 4:
                clock[0] += 0.05
                eng.poll()
        eng.flush()
        for t in tickets:
            t.result()
        snap = json.loads(json.dumps(obs.collect(), sort_keys=True, default=str))
        del eng, reg
        return snap
    finally:
        obs.disable()
        obs.reset()


def _metric(name, value, kind="counter", **labels):
    return {"name": name, "labels": labels, "type": kind, "value": value}


def _by_hand(scale: float = 1.0) -> dict:
    """Two plans of one registry: ``m`` with attribution (one strategy with
    no measured seconds), partition gauges and autotune provenance; ``n``
    with attribution only.  ``scale`` multiplies the served seconds."""
    attr = []
    for matrix, strategy, launches, mb, sec in (
        ("m", "fused", 12, 40e6, 0.004 * scale),
        ("m", "partials", 3, 9e6, 0.0),
        ("n", "fused", 5, 2e6, 0.010 * scale),
    ):
        lab = dict(matrix=matrix, strategy=strategy, k_tiling="grid")
        attr += [_metric("attr.launches", float(launches), **lab),
                 _metric("attr.bytes_modeled", mb, **lab),
                 _metric("attr.compute_s", sec, **lab)]
    plan = [_metric(f"plan.{k}", v, "gauge", matrix="m") for k, v in (
        ("tiles", 412.0), ("rowgroups", 96.0), ("nnz_utilization", 0.4375),
        ("occupancy_p10", 0.125), ("occupancy_p50", 0.375), ("occupancy_p90", 0.875),
        ("occupancy_mean", 0.4375), ("occupancy_min", 0.0625),
        ("rowgroup_imbalance", 2.25), ("competitive_ratio", 1.3),
        ("cohesion", 0.62), ("cohesion_random", 0.41), ("cohesion_score", 1.51),
        ("autotune_searched", 1.0), ("autotune_cache_hit", 0.0),
        ("autotune_evaluations", 3.0), ("autotune_objective_us", 81.5),
    )]
    plan += [_metric("plan.autotune_trial_us", us, "gauge", matrix="m", config=c)
             for c, us in (("r512.c4096.g8.l8", 81.5), ("r512.c4096.g8.l16", 95.25),
                           ("r512.c4096.g8.l32", 120.0))]
    plan += [_metric("plan.k_tiling_us", us, "gauge", matrix="m", k_tiling=kt)
             for kt, us in (("grid", 40.0), ("loop", 55.5))]
    plan.append(_metric("plan.k_tiling_choice", 1.0, "gauge", matrix="m", k_tiling="grid"))
    serving = [_metric("registry.preprocess_s", 1.25, matrix="m"),
               _metric("serving.requests", 40.0 * scale, matrix="m"),
               {"name": "serving.latency_s", "labels": {"matrix": "m"}, "type": "histogram",
                "count": 40, "p50": 0.002, "p95": 0.004 * scale, "p99": None, "max": 0.009},
               {"name": "solver.residual", "labels": {}, "type": "series", "count": 3,
                "first": 4.0, "last": 0.25, "min": 0.25}]
    return {
        "schema": 1,
        "registries": [{"registry": "serving", "metrics": attr + plan + serving},
                       {"registry": "global", "metrics": [
                           _metric("kernels.launches", 20.0, op="spmv", strategy="fused")]}],
        "spans": [
            {"name": "admit.hash", "count": 2, "total_ms": 8.0, "mean_ms": 4.0, "max_ms": 5.0},
            {"name": "serve.flush", "count": 4, "total_ms": 40.0 * scale,
             "mean_ms": 10.0 * scale, "max_ms": 12.0},
        ],
        "requests": [{"key": "m", "trace_id": f"t{i}", "queue_wait_s": 0.002 * i,
                      "compute_share_s": 0.001 * scale, "latency_s": 0.004 + 0.001 * i,
                      "batch_k": 4, "deadline_hit": True} for i in range(3)],
        "dropped_events": 0,
    }


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry")
    return {
        "jax_engine": _engine_snapshot(jobs, jserving, jcore, _mats(jmat), tmp / "jax"),
        "port_engine": _engine_snapshot(tobs, tserving, tcore, _mats(tmat), tmp / "torch",
                                        device="cpu"),
        "by_hand": _by_hand(),
    }


SNAPSHOTS = ("jax_engine", "port_engine", "by_hand")


def test_engine_snapshots_carry_attribution(snapshots):
    for name in ("jax_engine", "port_engine"):
        rows = tattr.attribution_rows(snapshots[name], hw=HW)
        assert {r["matrix"] for r in rows} == {"A", "B"}, name
        assert all(r["launches"] > 0 and r["bytes_modeled"] > 0 for r in rows), name


@pytest.mark.parametrize("snap", SNAPSHOTS)
def test_attribution_rows_and_table_match_jax(snapshots, snap):
    s = snapshots[snap]
    for flag_below in (0.5, 1e-9):
        rows = tattr.attribution_rows(s, hw=HW, flag_below=flag_below)
        assert rows == jattr.attribution_rows(s, hw=JHW, flag_below=flag_below)
        assert tattr.render_attribution(rows, hw=HW) == jattr.render_attribution(rows, hw=JHW)
    assert tattr.report(s, hw=HW) == jattr.report(s, hw=JHW)
    assert tattr.render_attribution([], hw=HW) == jattr.render_attribution([], hw=JHW)


def test_by_hand_attribution_values():
    rows = {(r["matrix"], r["strategy"]): r for r in tattr.attribution_rows(_by_hand(), hw=HW)}
    fused = rows["m", "fused"]
    assert fused["launches"] == 12 and fused["achieved_gbps"] == pytest.approx(10.0)
    assert fused["roofline_fraction"] == pytest.approx(10e9 / 3.35e12)
    assert fused["modeled_s"] == pytest.approx(40e6 / 3.35e12)
    assert rows["m", "partials"]["achieved_gbps"] is None
    assert not rows["m", "partials"]["below_roofline"]
    text = tattr.render_attribution(list(rows.values()), hw=HW)
    assert "vs h100_sxm @ 3350 GB/s" in text


@pytest.mark.parametrize("snap", SNAPSHOTS)
def test_dashboard_matches_jax(snapshots, snap):
    s = snapshots[snap]
    port = treport.render(s, hw=JAX_DEFAULT)
    assert port.startswith("== repro_torch.obs report ==\n")
    assert port.replace("repro_torch.obs report", "repro.obs report", 1) == jreport.render(s)
    assert treport.amortization_ledger(s) == jreport.amortization_ledger(s)


@pytest.mark.parametrize("snap", SNAPSHOTS)
def test_explain_matches_jax(snapshots, snap):
    s = snapshots[snap]
    matrices = {"by_hand": ("m", "n", "ghost")}.get(snap, ("A", "B", "ghost"))
    for matrix in matrices:
        text = tplan.explain_report(s, matrix, hw=HW)
        assert text == jplan.explain_report(s, matrix, hw=JHW), matrix
        assert tplan.explain(matrix, s, hw=HW) == text
        assert tplan.plan_metrics_from_snapshot(s, matrix) == jplan.plan_metrics_from_snapshot(
            s, matrix)
    text = tplan.explain_report(s, matrices[0], hw=HW)
    assert f"== explain: {matrices[0]} ==" in text
    if snap == "by_hand":
        assert "of h100_sxm HBM" in text and "mildly imbalanced" in text


@pytest.mark.parametrize("pair", ["engines", "by_hand", "empty", "bench"])
def test_diff_matches_jax(snapshots, pair):
    bench = {"schema": 1, "benches": [
        {"name": "spmm/grid", "min_us": 200.0, "median_us": 220.0},
        {"name": "preprocess/hash", "min_us": 100.0, "median_us": 110.0},
    ]}
    slow = {"schema": 1, "benches": [
        {"name": "spmm/grid", "min_us": 410.0, "median_us": 420.0},
        {"name": "preprocess/hash", "median_us": 100.0},
    ]}
    empty = {"schema": 1, "registries": [], "spans": [], "requests": []}
    a, b = {
        "engines": (snapshots["jax_engine"], snapshots["port_engine"]),
        "by_hand": (_by_hand(), _by_hand(scale=2.0)),
        "empty": (empty, empty),
        "bench": (bench, slow),
    }[pair]
    result = tdiff.diff_artifacts(a, b)
    assert result == jdiff.diff_artifacts(a, b)
    for top in (3, 20):
        assert tdiff.render_text(result, top=top) == jdiff.render_text(result, top=top)
        assert tdiff.render_markdown(result, top=top) == jdiff.render_markdown(result, top=top)
    if pair == "by_hand":
        assert result["culprit"]["name"] == "serve.flush"


def test_diff_rejects_mixed_and_unknown_artifacts():
    with pytest.raises(ValueError):
        tdiff.diff_artifacts(_by_hand(), {"benches": []})
    with pytest.raises(ValueError):
        tdiff.artifact_kind({"nothing": 1})


def _populate(metrics_mod, name):
    reg = metrics_mod.MetricRegistry(name=name)
    lab = dict(matrix="m4_kron16", strategy="fused", k_tiling="grid")
    reg.counter("attr.launches", **lab).inc(7)
    reg.counter("attr.bytes_modeled", **lab).inc(3.5e9)
    reg.counter("attr.compute_s", **lab).inc(0.0125)
    reg.counter("serving.requests", matrix='we"ird\\name').inc(2)
    reg.gauge("slo.burn_rate", matrix="m4_kron16", slo="deadline", window="60s").set(3.5)
    h = reg.histogram("serving.latency_s", buckets=[1e-3, 1e-2, 1e-1], matrix="m4_kron16")
    h.observe(5e-3, exemplar="r9-1")
    h.observe(5e-2)
    h.observe(2.0, exemplar="r9-2")
    reg.series("solver.residual").extend([4.0, 1.0, 0.25])
    return reg


def _attr_values(families):
    return {
        (fam, s["labels"]["strategy"]): s["value"]
        for fam in ("attr_launches", "attr_bytes_modeled", "attr_compute_s")
        for s in families[fam]["samples"]
    }


def test_openmetrics_matches_jax_and_round_trips():
    treg = _populate(tmetrics, "t-telemetry")
    text = texport.render_openmetrics([treg])
    assert text == jexport.render_openmetrics([_populate(jmetrics, "j-telemetry")])
    fam = texport.parse_openmetrics(text)
    assert fam == jexport.parse_openmetrics(text)
    assert _attr_values(fam) == {("attr_launches", "fused"): 7,
                                 ("attr_bytes_modeled", "fused"): 3.5e9,
                                 ("attr_compute_s", "fused"): 0.0125}
    (req,) = fam["serving_requests"]["samples"]
    assert req["labels"]["matrix"] == 'we"ird\\name' and req["value"] == 2
    buckets = [s for s in fam["serving_latency_s"]["samples"]
               if s["name"] == "serving_latency_s_bucket"]
    assert [s["value"] for s in buckets] == sorted(s["value"] for s in buckets)
    assert buckets[-1]["labels"]["le"] == "+Inf" and buckets[-1]["value"] == 3
    (last,) = fam["solver_residual_last"]["samples"]
    assert last["value"] == 0.25
    with pytest.raises(ValueError):
        texport.parse_openmetrics(text.replace("# EOF\n", ""))


def test_metrics_server_scrape_on_loopback_port_0(tmp_path):
    reg = _populate(tmetrics, "t-scrape")
    snap_attr = {
        (f"attr_{m['name'].split('.', 1)[1]}", m["labels"]["strategy"]): m["value"]
        for m in reg.collect()["metrics"] if m["name"].startswith("attr.")
    }
    with texport.serve(port=0, registries=[reg]) as srv:
        assert srv.port != 0 and srv.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            assert resp.headers["Content-Type"] == texport.CONTENT_TYPE
            fam = texport.parse_openmetrics(resp.read().decode("utf-8"))
        assert _attr_values(fam) == snap_attr
        reg.counter("attr.launches", matrix="m4_kron16", strategy="fused",
                    k_tiling="grid").inc(3)
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            fam = texport.parse_openmetrics(resp.read().decode("utf-8"))
        assert _attr_values(fam)["attr_launches", "fused"] == 10
    path = tmp_path / "metrics.prom"
    with texport.FileExporter(path, interval_s=3600, registries=[reg]) as fx:
        assert fx.writes == 1
    assert fx.writes == 2
    assert path.read_text() == texport.render_openmetrics([reg])
    assert texport.write_prom(path, [reg]) == path.read_text()


def test_obs_facade_has_report_and_export():
    tobs.reset()
    reg = tmetrics.MetricRegistry(name="t-facade")
    reg.counter("serving.requests", matrix="q").inc(4)
    text = tobs.report(hw=HW)
    assert text.startswith("== repro_torch.obs report ==")
    assert "serving.requests{matrix=q}" in text
    # still the function after the dashboard module was imported and used
    importlib.import_module("repro_torch.obs.report")
    again = tobs.report(hw=HW)
    assert again.startswith("== repro_torch.obs report ==")
    assert "serving.requests{matrix=q}" in again
    assert "serving_requests_total" in tobs.export.render_openmetrics()
    del reg


@pytest.mark.parametrize("name, spec", [
    ("NVIDIA H100 80GB HBM3", troof.H100_SXM),
    ("NVIDIA H100 PCIe", troof.H100_PCIE),
    ("NVIDIA H100 NVL", troof.H100_NVL),
    ("NVIDIA H200", troof.H200),
    ("h100_sxm", troof.H100_SXM),
])
def test_spec_for_the_parts(name, spec):
    assert troof.spec_for(name) == spec


def test_spec_values_and_unknown_parts():
    assert (HW.hbm_bw, HW.peak_flops, HW.hbm_bytes, HW.link_bw) == (3.35e12, 67e12, 80e9, 450e9)
    for name in ("NVIDIA A100-SXM4-80GB", "Tesla V100", "tpu_v5e", ""):
        with pytest.raises(ValueError, match="no peak rates"):
            troof.spec_for(name)


def test_roofline_terms_match_jax():
    for flops, byts, coll in ((2e9, 4e9, 0.0), (9e13, 1e9, 5e9), (1.0, 2.0, 1e12)):
        t = troof.RooflineTerms(flops, byts, coll, HW)
        assert t.as_dict() == jroof.RooflineTerms(flops, byts, coll, JHW).as_dict()
        assert t.t_bound == max(t.t_compute, t.t_memory, t.t_collective)


def test_hw_none_without_a_card_raises(monkeypatch, snapshots):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = _by_hand()
    rows = tattr.attribution_rows(s, hw=HW)
    for call in (
        lambda: tattr.attribution_rows(s),
        lambda: tattr.attribution_rows({"registries": []}),
        lambda: tattr.render_attribution(rows),
        lambda: tattr.report(s),
        lambda: tplan.explain_report(s, "m"),
        lambda: treport.render(s),
        lambda: troof.card_spec(),
    ):
        with pytest.raises(RuntimeError, match="hw="):
            call()
    # a dashboard with no attribution counters needs no peak rates
    no_attr = {"registries": [{"registry": "r", "metrics": [
        _metric("serving.requests", 3.0, matrix="m")]}]}
    assert "serving.requests{matrix=m}" in treport.render(no_attr)
    with pytest.raises(ValueError):
        troof.card_spec("cpu")


def test_report_cli_modes(snapshots, tmp_path, capsys):
    s = snapshots["by_hand"]
    path = tmp_path / "obs.json"
    path.write_text(json.dumps(s))
    other = tmp_path / "obs2.json"
    other.write_text(json.dumps(_by_hand(scale=2.0)))
    want = {
        ("--attribution", str(path)): tattr.render_attribution(
            tattr.attribution_rows(s, hw=HW), hw=HW) + "\n",
        ("--obs", str(path)): treport.render(s, hw=HW) + "\n",
        ("--explain", "m", "--obs", str(path)): tplan.explain_report(s, "m", hw=HW),
        ("--requests", str(path), "--top", "2"): tobs.waterfall(s, n=2) + "\n",
        ("--diff", str(path), str(other)): tdiff.render_text(
            tdiff.diff_artifacts(s, _by_hand(scale=2.0))),
    }
    for args, text in want.items():
        tcli.main([*args, "--hw", "NVIDIA H100 80GB HBM3"])
        assert capsys.readouterr().out == text, args
    # with no mode flag the CLI renders the dry-run tables of --dir, as the
    # JAX package's does (an empty directory: every cell missing)
    tcli.main(["--dir", str(tmp_path / "no_records")])
    out = capsys.readouterr().out
    assert "## §Dry-run matrix" in out and "cells: 0 recorded" in out and "MISSING" in out
    with pytest.raises(ValueError, match="no peak rates"):
        tcli.main(["--attribution", str(path), "--hw", "tpu_v5e"])
