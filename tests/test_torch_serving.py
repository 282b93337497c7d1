"""The port's registry and serving engine against the JAX package's.

Both registries admit the same matrices under the same pinned geometry;
both engines run on a virtual clock and receive the same mixed-k request
stream over two matrices.  Every ticket of the port must equal the JAX
engine's answer within ``rtol=1e-5, atol=1e-5 * max(1, |y_jax|_inf)``
(the lane sums are taken in different orders) and equal the port's own
``plan.matvec`` bitwise — the engine's coalescing contract.  The port
serves on the CPU (``device="cpu"``).
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.matrices as jmat
import repro.serving as jserving
import repro_torch.core as tcore
import repro_torch.core.matrices as tmat
import repro_torch.serving as tserving

SMALL = dict(row_block=64, col_block=128, group=8, lane=16)


def _mats(m):
    return {
        "A": m.circuit(150, seed=1, n_dense_rows=2, dense_row_frac=0.05),
        "B": m.banded_fem(130, seed=3, band=4, fill=0.9),
    }


def _close(y_port, y_jax):
    y_jax = np.asarray(y_jax)
    atol = 1e-5 * max(1.0, float(np.abs(y_jax).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(y_port), y_jax, rtol=1e-5, atol=atol)


def _stream(mats, n=27, seed=7):
    """Interleaved requests: (key, x), deliberately awkward per-key counts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = "B" if i % 3 == 2 else "A"
        out.append((key, rng.standard_normal(mats[key].shape[1]).astype(np.float32)))
    return out


def _serve(eng, stream, clock):
    """Submit the stream, advancing the virtual clock so deadline flushes
    fire between bursts (mixed batch widths), then drain."""
    tickets = []
    for i, (key, x) in enumerate(stream):
        tickets.append(eng.submit(key, x))
        if i % 5 == 4:
            clock[0] += 0.05
            eng.poll()
    eng.flush()
    return tickets


@pytest.fixture()
def registries(tmp_path):
    jreg = jserving.MatrixRegistry(cache_dir=tmp_path / "jax", search=False)
    jm = _mats(jmat)
    for key, csr in jm.items():
        jreg.admit(csr, key, cfg=jcore.PartitionConfig(**SMALL))
    return jreg, jm


def _port_registry(tmp_path, strategy=None, **kw):
    treg = tserving.MatrixRegistry(
        device="cpu", cache_dir=tmp_path / "torch", search=False, strategy=strategy, **kw
    )
    tm = _mats(tmat)
    for key, csr in tm.items():
        treg.admit(csr, key, cfg=tcore.PartitionConfig(**SMALL))
    return treg, tm


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("strategy", ["stable", "fused", "partials"])
def test_mixed_k_traffic_matches_jax_and_matvec(tmp_path, registries, strategy, overlap):
    jreg, jm = registries
    treg, tm = _port_registry(tmp_path, strategy)
    stream = _stream(tm)
    jclock, tclock = [0.0], [0.0]
    jeng = jserving.ServingEngine(
        jreg, max_batch=8, max_wait_s=0.01, clock=lambda: jclock[0], overlap=overlap
    )
    teng = tserving.ServingEngine(
        treg, max_batch=8, max_wait_s=0.01, clock=lambda: tclock[0], overlap=overlap
    )
    jt = _serve(jeng, stream, jclock)
    tt = _serve(teng, stream, tclock)
    for (key, x), j, t in zip(stream, jt, tt):
        y = t.result()
        assert isinstance(y, np.ndarray) and y.dtype == np.float32
        assert y.shape == (tm[key].shape[0],)
        _close(y, j.result())
        y1 = treg.get(key).matvec(x)
        assert isinstance(y1, torch.Tensor)
        assert np.array_equal(y, y1.numpy()), key  # bitwise
    # both engines coalesced the stream into the same batches
    ts, js = teng.stats(), jeng.stats()
    for key in ("A", "B"):
        assert ts[key]["requests"] == js[key]["requests"]
        assert ts[key]["batches"] == js[key]["batches"]
        assert ts[key]["pad_fraction"] == pytest.approx(js[key]["pad_fraction"])
    assert teng.inflight() == 0


def test_stats_key_sets_match_jax(tmp_path, registries):
    jreg, jm = registries
    treg, tm = _port_registry(tmp_path)
    jeng = jserving.ServingEngine(jreg, clock=lambda: 0.0)
    teng = tserving.ServingEngine(treg, clock=lambda: 0.0)
    for eng, m in ((jeng, jm), (teng, tm)):
        eng.submit("A", np.ones(m["A"].shape[1], np.float32)).result()
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js) == {"A", "B"}
    for key in js:
        assert set(ts[key]) == set(js[key])
        assert set(ts[key]["quality"]) == set(js[key]["quality"])
        assert set(ts[key]["provenance"]) == set(js[key]["provenance"])
        assert ts[key]["config"] == js[key]["config"]
        assert ts[key]["matrix_hash"] == js[key]["matrix_hash"]
        for q in ("tiles", "nnz_utilization", "rowgroup_imbalance", "competitive_ratio"):
            assert ts[key]["quality"][q] == pytest.approx(js[key]["quality"][q])
    assert set(treg.stats()) == set(jreg.stats())
    assert set(teng.health()) == set(jeng.health())


def test_qos_backpressure_is_typed(tmp_path):
    treg, tm = _port_registry(tmp_path)
    vt = [0.0]
    eng = tserving.ServingEngine(
        treg,
        clock=lambda: vt[0],
        qos={"A": tserving.QoSClass("tight", deadline_s=0.001, max_queue=3)},
    )
    x = np.ones(tm["A"].shape[1], np.float32)
    tickets = [eng.submit("A", x) for _ in range(3)]
    with pytest.raises(tserving.BackpressureError) as info:
        eng.submit("A", x)
    assert info.value.key == "A" and info.value.limit == 3
    assert eng.metrics.value("qos.shed", matrix="A", qos="tight") == 1
    assert all(t.result().shape == (tm["A"].shape[0],) for t in tickets)
    assert eng.stats()["A"]["shed"] == 1
    eng.submit("B", np.ones(tm["B"].shape[1], np.float32)).result()  # default class


def test_budget_eviction_restages_bitwise(tmp_path):
    tm = _mats(tmat)
    cfg = tcore.PartitionConfig(**SMALL)
    probe = tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path / "c", search=False)
    nbytes = tserving.plan_device_bytes(probe.admit(tm["A"], "p", cfg=cfg).device)
    reg = tserving.MatrixRegistry(
        device="cpu", cache_dir=tmp_path / "c", search=False,
        hbm_budget_bytes=int(nbytes * 1.5),
    )
    plan_a = reg.admit(tm["A"], "a", cfg=cfg)
    x = np.random.default_rng(0).standard_normal(tm["A"].shape[1]).astype(np.float32)
    y_before = plan_a.matvec(x)
    reg.admit(tm["B"], "b", cfg=cfg)  # overflows the budget: "a" is unstaged
    assert plan_a.device is None
    assert reg.metrics.value("evict.unstaged", matrix="a") == 1
    assert reg.get("a") is plan_a and plan_a.device is not None
    assert reg.metrics.value("evict.restages", matrix="a") == 1
    assert torch.equal(plan_a.matvec(x), y_before)
    # the engine sees nothing of it: submit's get() re-stages "b" if needed
    eng = tserving.ServingEngine(reg, clock=lambda: 0.0)
    y = eng.submit("a", x).result()
    assert np.array_equal(y, y_before.numpy())


def test_registry_device_and_strategy_defaults(tmp_path):
    reg = tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path)
    assert reg.device == torch.device("cpu") and reg.strategy == "stable"
    reg = tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path, strategy="fused")
    assert reg.strategy == "fused"
    reg = tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path, strategy="partials")
    assert reg.strategy == "partials"
    with pytest.raises(ValueError):
        tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path, strategy="bogus")
    with pytest.raises(ValueError):
        tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path, k_tiling="bogus")


def test_deferred_registry_surface_raises(tmp_path):
    """The solver surface stays deferred, naming its ROADMAP item; every
    aggregation, the max combine and the training surface (the A/Aᵀ pair,
    differentiable aggregation) are served."""
    treg, tm = _port_registry(tmp_path)
    plan = treg.get("A")
    x = np.ones((tm["A"].shape[1], 2), np.float32)
    for op in ("sum", "mean", "max"):
        assert plan.aggregate(x, op=op).shape == (tm["A"].shape[0], 2)
    assert plan.matmat(x, combine="max").shape == (tm["A"].shape[0], 2)
    with pytest.raises(ValueError):
        plan.aggregate(x, op="min")
    pair = treg.admit_pair(tm["A"], "A2")
    assert pair is plan and treg.transpose_of(plan).name == "A::T"
    assert plan.diff_aggregator(op="max")(x).shape == (tm["A"].shape[0], 2)
    for call, item in (
        (lambda: plan.operator(), "item 5"),
        (lambda: plan.jacobi(), "item 5"),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP") as info:
            call()
        assert item in str(info.value)


def test_readmission_is_content_addressed(tmp_path):
    treg, tm = _port_registry(tmp_path)
    again = treg.admit(tcore.csr_from_dense(tm["A"].to_dense()))
    assert again is treg.get("A")
    assert treg.metrics.value("registry.hits", matrix="A") == 1
    assert treg.stats()["A"]["admissions"] == 2
    treg.evict("A")
    assert "A" not in treg and len(treg) == 1


def test_measured_search_keeps_its_own_cache_entries(tmp_path):
    """The port's searched entries never satisfy the JAX package's, nor
    overwrite them: separate files, framework and device in the key."""
    cands = [
        dict(row_block=64, col_block=128, group=8, lane=8),
        dict(row_block=64, col_block=128, group=8, lane=16),
    ]
    cache = tmp_path / "shared"
    A_j, A_t = _mats(jmat)["A"], _mats(tmat)["A"]
    jreg = jserving.MatrixRegistry(
        cache_dir=cache, candidates=[jcore.PartitionConfig(**c) for c in cands]
    )
    jreg.admit(A_j, "A")
    treg = tserving.MatrixRegistry(
        device="cpu", cache_dir=cache, candidates=[tcore.PartitionConfig(**c) for c in cands]
    )
    plan = treg.admit(A_t, "A")
    assert plan.autotune_searched and not plan.autotune_cache_hit
    assert len(plan.provenance["trials"]) == 2
    key = tserving.matrix_hash(A_t)
    assert (cache / f"{key}.json").exists() and (cache / f"{key}.torch.json").exists()
    treg2 = tserving.MatrixRegistry(
        device="cpu", cache_dir=cache, candidates=[tcore.PartitionConfig(**c) for c in cands]
    )
    plan2 = treg2.admit(A_t, "A")
    assert plan2.autotune_cache_hit and dataclasses.asdict(plan2.cfg) in cands
    # a different device type is a different objective: no cache hit
    fp_cpu = tserving.spmm_probe(device="cpu").params
    fp_cuda = tserving.spmm_probe(device="cuda").params
    assert fp_cpu != fp_cuda and "cpu" in fp_cpu


def test_partials_probe_and_k_tilings(tmp_path):
    """The measured search and the k_tiling measurement serve "partials"."""
    A = _mats(tmat)["B"]
    cands = [tcore.PartitionConfig(**SMALL), tcore.PartitionConfig(**{**SMALL, "lane": 8})]
    reg = tserving.MatrixRegistry(
        device="cpu", cache_dir=tmp_path, candidates=cands, strategy="partials",
        k_tiling="auto",
    )
    plan = reg.admit(A, "B")
    assert plan.autotune_searched and len(plan.provenance["trials"]) == 2
    assert set(plan.provenance["k_tiling_us"]) == {"grid", "loop"}
    probe = tserving.spmm_probe(strategy="partials", device="cpu")
    assert probe.params == (8, "partials", "cpu")
    with pytest.raises(ValueError):
        tserving.spmm_probe(strategy="bogus")


def test_auto_k_tiling_keeps_grid_for_stable(tmp_path):
    treg = tserving.MatrixRegistry(
        device="cpu", cache_dir=tmp_path, search=False, k_tiling="auto"
    )
    plan = treg.admit(_mats(tmat)["B"], "B")
    assert plan.k_tiling == "grid" and plan.provenance["k_tiling_us"] is None
    us = tserving.measure_k_tilings(
        _mats(tmat)["B"], plan.cfg, strategy="fused", repeats=1, device="cpu"
    )
    assert set(us) == {"grid", "loop"}
