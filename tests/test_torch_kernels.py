"""The port's SpMV/SpMM entry points against the JAX package's.

Both packages get exactly the same tiles (the JAX build, carried over
with ``tiles_from_arrays``) and the same x, drawn from a seeded numpy
generator.  The JAX side runs its fused Pallas kernels in interpret mode
and its ``"stable"``/``"reference"`` strategies on their jnp paths, as its
own tests do; the port runs on the CPU, where the fused wrappers take
their plain PyTorch versions.

Tolerance: ``rtol=1e-5, atol=1e-5 * max(1, |y_jax|_inf)`` — the two
implementations reduce the lanes in different orders.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch.kernels import ops as tops
from repro_torch.kernels.hbp_spmv import (
    hbp_spmm_fused,
    hbp_spmv_fused,
    hbp_spmv_fused_plain,
)

KS = (1, 3, 8, 128, 129, 256)
LANES = (8, 128)
FIELDS = ("data", "cols", "rowgroup", "colblock", "first", "perm")


def _close(y_port, y_jax):
    y_jax = np.asarray(y_jax)
    atol = 1e-5 * max(1.0, float(np.abs(y_jax).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(y_port), y_jax, rtol=1e-5, atol=atol)


def _dense(seed, n_rows=60, n_cols=80, density=0.15, zero_rows=None):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n_rows, n_cols)) * (rng.random((n_rows, n_cols)) < density)
    if zero_rows is not None:
        dense[zero_rows] = 0.0
    return dense.astype(np.float32)


def _pair(dense, lane):
    """(JAX tiles, the same tiles staged by the port on the CPU)."""
    cfg = jcore.PartitionConfig(row_block=32, col_block=32, group=8, lane=lane)
    tj = jcore.build_tiles(jcore.csr_from_dense(dense), cfg)
    d = {f: getattr(tj, f) for f in FIELDS}
    d.update(shape=tj.shape, n_rowgroups=tj.n_rowgroups, cfg=dataclasses.asdict(cfg))
    return tj, tops.device_tiles(tcore.tiles_from_arrays(d), "cpu")


@pytest.fixture(scope="module", params=LANES, ids=lambda lane: f"lane{lane}")
def tiles(request):
    return _pair(_dense(request.param), request.param)


@pytest.fixture(scope="module")
def zero_groups():
    # rows 16..47 hold nothing: the hash clusters them into whole empty
    # row groups, which own no tiles and must come out exactly 0
    dense = _dense(7, n_rows=96, n_cols=70, zero_rows=slice(16, 48))
    tj, dt = _pair(dense, 8)
    assert len(np.unique(tj.rowgroup)) < tj.n_rowgroups
    return dense, tj, dt


@pytest.mark.parametrize("strategy", ["fused", "stable", "reference"])
def test_spmv_matches_jax(tiles, strategy):
    tj, dt = tiles
    x = np.random.default_rng(1).standard_normal(tj.shape[1]).astype(np.float32)
    y_j = jops.hbp_spmv(tj, x, strategy=strategy, interpret=True)
    _close(tops.hbp_spmv(dt, x, strategy=strategy), y_j)


# under "loop" only widths above one 128-wide launch differ from "grid"
FUSED_CASES = [(k, "grid") for k in KS] + [(k, "loop") for k in KS if k > 128]


@pytest.mark.parametrize("k,k_tiling", FUSED_CASES)
def test_fused_spmm_matches_jax(tiles, k, k_tiling):
    tj, dt = tiles
    X = np.random.default_rng(k).standard_normal((tj.shape[1], k)).astype(np.float32)
    y_j = jops.hbp_spmm(tj, X, strategy="fused", interpret=True, k_tiling=k_tiling)
    _close(tops.hbp_spmm(dt, X, strategy="fused", k_tiling=k_tiling), y_j)


@pytest.mark.parametrize("strategy", ["fused", "stable", "reference"])
def test_zero_row_groups_come_out_zero(zero_groups, strategy):
    dense, tj, dt = zero_groups
    X = np.random.default_rng(3).standard_normal((70, 5)).astype(np.float32)
    Y = tops.hbp_spmm(dt, X, strategy=strategy).numpy()
    assert np.all(Y[16:48] == 0.0)
    _close(Y, jops.hbp_spmm(tj, X, strategy=strategy, interpret=True))
    np.testing.assert_allclose(Y, dense @ X, rtol=1e-5, atol=1e-5)
    # in hashed order: every row group without a run is exactly zero
    y_h = hbp_spmm_fused(dt, torch.as_tensor(X))
    empty = np.setdiff1d(np.arange(tj.n_rowgroups), tj.rowgroup)
    assert empty.size and torch.all(y_h[torch.as_tensor(empty)] == 0)


@pytest.mark.parametrize("strategy", ["fused", "stable"])
def test_batch_width_and_padding_invariance_is_bitwise(tiles, strategy):
    """A column's bits do not depend on the batch width, on zero padding
    to a bucket, or on the k_tiling contract; SpMV equals the column."""
    tj, dt = tiles
    rng = np.random.default_rng(11)
    x = rng.standard_normal(tj.shape[1]).astype(np.float32)
    y1 = tops.hbp_spmv(dt, x, strategy=strategy)
    for k in (1, 5, 8, 128, 200):
        X = rng.standard_normal((tj.shape[1], k)).astype(np.float32)
        X[:, k // 2] = x
        for kt in ("grid", "loop"):
            Y = tops.hbp_spmm(dt, X, strategy=strategy, k_tiling=kt)
            assert torch.equal(Y[:, k // 2], y1), (k, kt)
        Yb = tops.hbp_spmm_bucketed(dt, X, strategy=strategy)
        assert Yb.shape == (tj.shape[0], k)
        assert torch.equal(Yb[:, k // 2], y1), k


def test_plain_fused_spmv_equals_spmm_column(tiles):
    tj, dt = tiles
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(tj.shape[1]).astype(np.float32))
    X = torch.as_tensor(rng.standard_normal((tj.shape[1], 16)).astype(np.float32))
    X[:, 9] = x
    y = hbp_spmv_fused(dt, x)
    assert y.shape == (tj.n_rowgroups, tj.cfg.group)
    assert torch.equal(hbp_spmm_fused(dt, X)[..., 9], y)
    # on the CPU the wrappers run the plain versions and launch nothing
    assert torch.equal(hbp_spmv_fused_plain(dt, x), y)


def test_empty_matrix():
    tj, dt = _pair(np.zeros((20, 30), np.float32), 8)
    X = np.ones((30, 4), np.float32)
    assert torch.equal(tops.hbp_spmm(dt, X), torch.zeros(20, 4))
    assert torch.equal(tops.hbp_spmv(dt, X[:, 0]), torch.zeros(20))


def test_traffic_model_counts_stream_passes(tiles):
    _, dt = tiles
    assert tops.stream_passes(256, "fused", "grid") == 1
    assert tops.stream_passes(256, "fused", "loop") == 2
    assert tops.stream_passes(100, "stable", "loop") == 1
    one = tops.modeled_launch_bytes(dt, 128, "fused", "grid")
    two = tops.modeled_launch_bytes(dt, 256, "fused", "loop")
    stream = dt.data.nbytes + dt.cols.nbytes + dt.colblock.nbytes
    assert two > 2 * one - 2 * (dt.n_rowgroups * 8 * 128 * 4) and one > stream


def test_deferred_paths_raise_not_implemented(tiles):
    _, dt = tiles
    X = np.ones((dt.shape[1], 2), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.hbp_spmm(dt, X, strategy="partials")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.hbp_spmv(dt, X[:, 0], strategy="partials")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.hbp_spmm(dt, X, combine="max")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.hbp_spmm_argmax(dt, X)
    with pytest.raises(ValueError):
        tops.hbp_spmm(dt, X, strategy="bogus")
    with pytest.raises(ValueError):
        tops.hbp_spmm(dt, X, k_tiling="bogus")


def test_wrappers_check_their_operands(tiles):
    _, dt = tiles
    with pytest.raises(ValueError, match="n_cols"):
        hbp_spmv_fused(dt, torch.zeros(dt.shape[1] + 1))
    with pytest.raises(TypeError, match="float32"):
        hbp_spmm_fused(dt, torch.zeros((dt.shape[1], 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="n_rows"):
        tops.hbp_spmv(dt, np.zeros(dt.shape[1], np.float32), n_rows=dt.shape[0] + 1)
    x = np.zeros(dt.shape[1], np.float32)
    assert tops.hbp_spmv(dt, x, device="cpu").shape == (dt.shape[0],)
    with pytest.raises(ValueError, match="staged on"):
        tops.hbp_spmv(dt, x, device="meta")
