"""The port's own telemetry copy: the gated facade and the
partition-quality metrics against the JAX package's on the same tiles."""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest

import repro.core as jcore
import repro.core.matrices as jmat
from repro.obs import planview as jplanview
import repro_torch.core as tcore
import repro_torch.core.matrices as tmat
from repro_torch import obs
from repro_torch.obs import planview as tplanview


@pytest.fixture()
def enabled_obs():
    obs.reset()
    obs.enable()
    yield obs
    obs.disable()
    obs.reset()


def test_disabled_facade_is_noop():
    obs.disable()
    assert obs.span("x") is obs.NOOP and obs.counter("c") is obs.NOOP
    # the dashboard and the OpenMetrics exporter are part of the facade
    assert callable(obs.report) and callable(obs.export.render_openmetrics)


def test_enabled_facade_records_spans_and_counters(enabled_obs):
    with obs.span("admit.test", matrix="m") as sp:
        sp.annotate(tiles=3)
    obs.counter("kernels.launches", op="spmv").inc(2)
    snap = obs.collect()
    assert snap["enabled"] and snap["n_events"] == 1
    assert [s["name"] for s in snap["spans"]] == ["admit.test"]
    names = {m["name"] for r in snap["registries"] for m in r["metrics"]}
    assert "kernels.launches" in names


def test_kernel_entry_points_count_launches_when_enabled(enabled_obs):
    from repro_torch.kernels import ops

    csr = tmat.banded_fem(100, seed=1, band=3)
    dt = ops.device_tiles(tcore.build_tiles(csr, tcore.PartitionConfig(lane=8)), "cpu")
    ops.hbp_spmm(dt, np.ones((100, 3), np.float32), strategy="stable")
    assert obs.registry().value("kernels.launches", op="spmm", strategy="stable",
                                combine="sum") == 1
    assert obs.registry().value("kernels.bytes_modeled") == ops.modeled_launch_bytes(
        dt, 3, "stable"
    )


@pytest.mark.parametrize("gen", ["circuit", "dense_block"])
def test_partition_quality_matches_jax(gen):
    make = {
        "circuit": lambda m: m.circuit(400, seed=2, n_dense_rows=2, dense_row_frac=0.05),
        "dense_block": lambda m: m.dense_block(600, seed=4, block=64, n_blocks=3),
    }[gen]
    cfg = dict(row_block=64, col_block=128, group=8, lane=16)
    csr_j, csr_t = make(jmat), make(tmat)
    qj = jplanview.partition_quality(jcore.build_tiles(csr_j, jcore.PartitionConfig(**cfg)), csr_j)
    qt = tplanview.partition_quality(tcore.build_tiles(csr_t, tcore.PartitionConfig(**cfg)), csr_t)
    assert set(qj) == set(qt)
    for key, v in qj.items():
        if isinstance(v, list):
            np.testing.assert_allclose(qt[key], v)
        elif v is None:
            assert qt[key] is None
        else:
            assert qt[key] == pytest.approx(v), key


def test_register_plan_metrics_publishes_gauges():
    from repro_torch.obs.metrics import MetricRegistry

    csr = tmat.circuit(200, seed=1)
    tiles = tcore.build_tiles(csr, tcore.PartitionConfig(row_block=64, col_block=128, lane=8))
    quality = tplanview.partition_quality(tiles, csr)
    m = MetricRegistry(name="t")
    prov = {"searched": True, "cache_hit": False, "evaluations": 1, "objective_us": 5.0,
            "trials": [{"config": dataclasses.asdict(tiles.cfg), "objective_us": 5.0}],
            "k_tiling": "grid"}
    tplanview.register_plan_metrics(m, "c", quality, prov)
    assert m.value("plan.tiles", matrix="c") == tiles.n_tiles
    assert m.value("plan.autotune_searched", matrix="c") == 1.0
