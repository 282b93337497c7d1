"""The port's SpMV/SpMM entry points against the JAX package's.

Both packages get exactly the same tiles (the JAX build, carried over
with ``tiles_from_arrays``) and the same x, drawn from a seeded numpy
generator.  The JAX side runs its fused and partials Pallas kernels in
interpret mode and its ``"stable"``/``"reference"`` strategies on their
jnp paths, as its own tests do; the port runs on the CPU, where the
kernel wrappers take their plain PyTorch versions.

Tolerance: sums ``rtol=1e-5, atol=1e-5 * max(1, |y_jax|_inf)`` — the two
implementations reduce the lanes in different orders; the max monoid
exactly, on every strategy.
"""
import dataclasses
import importlib
import itertools

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch import obs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.hbp_spmv import (
    PartialsGeometry,
    hbp_spmm_fused,
    hbp_spmm_fused_max,
    hbp_spmm_partials,
    hbp_spmm_partials_max,
    hbp_spmv_fused,
    hbp_spmv_fused_plain,
    hbp_spmv_partials,
    partials_geometry,
)

from hub_runs import hub_config, hub_coo

# the kernels' module (``repro_torch.kernels.hbp_spmv`` is also the name of
# the ops entry point, which an attribute lookup on the package returns)
K = importlib.import_module("repro_torch.kernels.hbp_spmv")

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
    return _pair_csr(jcore.csr_from_dense(dense), lane)


def _pair_csr(csr, lane, **geometry):
    geometry = geometry or dict(row_block=32, col_block=32, group=8)
    cfg = jcore.PartitionConfig(**{**geometry, "lane": lane})
    tj = jcore.build_tiles(csr, cfg)
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


@pytest.mark.parametrize("strategy", ["fused", "partials", "stable", "reference"])
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


@pytest.mark.parametrize("k,k_tiling", FUSED_CASES)
def test_partials_spmm_matches_jax(tiles, k, k_tiling):
    tj, dt = tiles
    X = np.random.default_rng(k).standard_normal((tj.shape[1], k)).astype(np.float32)
    y_j = jops.hbp_spmm(tj, X, strategy="partials", interpret=True, k_tiling=k_tiling)
    _close(tops.hbp_spmm(dt, X, strategy="partials", k_tiling=k_tiling), y_j)


# the JAX "stable"/"reference" max chains unroll every lane into their
# trace; at lane 128 each new width costs seconds of compilation, so that
# lane runs one width below and one above a 128-wide chunk there
_MAX_WIDTHS = ((1, "grid"), (8, "grid"), (129, "grid"), (256, "grid"), (256, "loop"))
MAX_CASES = [
    (lane, s, k, kt)
    for lane in LANES
    for s in ("fused", "partials", "stable", "reference")
    for k, kt in _MAX_WIDTHS
    if lane == 8 or s in ("fused", "partials") or (k, kt) in ((8, "grid"), (129, "grid"))
]
_LANE_TILES = {}


@pytest.mark.parametrize("lane,strategy,k,k_tiling", MAX_CASES)
def test_max_matches_jax_exactly(lane, strategy, k, k_tiling):
    if lane not in _LANE_TILES:
        _LANE_TILES[lane] = _pair(_dense(lane), lane)  # the ``tiles`` fixture's matrix
    tj, dt = _LANE_TILES[lane]
    X = np.random.default_rng(k + 1).standard_normal((tj.shape[1], k)).astype(np.float32)
    y_j = np.asarray(
        jops.hbp_spmm(tj, X, strategy=strategy, combine="max", interpret=True, k_tiling=k_tiling)
    )
    y_t = tops.hbp_spmm(dt, X, strategy=strategy, combine="max", k_tiling=k_tiling).numpy()
    np.testing.assert_array_equal(y_t, y_j)


def _numpy_max(csr, X):
    """f32 max of ``a * x`` over each row's stored nonzeros, 0 for rows
    with none: the semantics of ``combine="max"``."""
    out = np.zeros((csr.shape[0], X.shape[1]), np.float32)
    for r in range(csr.shape[0]):
        lo, hi = csr.indptr[r], csr.indptr[r + 1]
        a = csr.data[lo:hi].astype(np.float32)
        live = a != 0
        if live.any():
            out[r] = (a[live, None] * X[csr.indices[lo:hi][live]]).max(axis=0)
    return out


@pytest.fixture(scope="module")
def max_edge_cases():
    """Empty row groups, an all-negative row and explicitly stored zeros."""
    dense = _dense(9, n_rows=96, n_cols=70, zero_rows=slice(16, 48))
    dense[60] = -np.abs(dense[60])
    dense[60, :3] = -1.0  # every entry negative
    csr = jcore.csr_from_dense(dense)
    # store explicit zeros: row 70 holds only zeros, row 60 a zero beside
    # its negative entries; both must ignore them (a stored 0 is no edge)
    rows = np.repeat(np.arange(96), np.diff(csr.indptr))
    extra = np.array([[70, 5], [70, 40], [60, 69]])
    keep = ~np.isin(rows * 70 + csr.indices, extra[:, 0] * 70 + extra[:, 1])
    dense[70] = 0.0
    keep &= rows != 70
    r = np.concatenate([rows[keep], extra[:, 0]])
    c = np.concatenate([csr.indices[keep], extra[:, 1]])
    v = np.concatenate([csr.data[keep], np.zeros(3)]).astype(np.float32)
    with_zeros = jcore.csr_from_coo(jcore.COOMatrix(r, c, v, (96, 70)), sum_duplicates=False)
    assert with_zeros.nnz == int(keep.sum()) + 3
    tj, dt = _pair_csr(with_zeros, 8)
    assert len(np.unique(tj.rowgroup)) < tj.n_rowgroups
    return with_zeros, tj, dt


@pytest.mark.parametrize("strategy", ["fused", "partials", "stable", "reference"])
def test_max_edge_cases(max_edge_cases, strategy):
    csr, tj, dt = max_edge_cases
    X = np.abs(np.random.default_rng(4).standard_normal((70, 6))).astype(np.float32) + 0.1
    X[:, 5] = -X[:, 5]  # a column where row 60's products are all positive
    Y = tops.hbp_spmm(dt, X, strategy=strategy, combine="max").numpy()
    np.testing.assert_array_equal(Y, _numpy_max(csr, X))
    np.testing.assert_array_equal(
        Y, np.asarray(jops.hbp_spmm(tj, X, strategy=strategy, combine="max", interpret=True))
    )
    assert np.all(Y[16:48] == 0.0) and np.all(Y[70] == 0.0)
    assert np.all(Y[60, :5] < 0.0) and Y[60, 5] > 0.0


def _nan_matrix():
    """``_dense(3)`` with three NaN probes: column 10 is read by live slots
    (row 20 among them); row 5's only entry is at column 40; column 64 (the
    first of column block 2) holds no entry, so only padded slots read
    its x row."""
    dense = _dense(3)
    dense[20, 10] = 0.7
    dense[5] = 0.0
    dense[5, 40] = 1.5
    dense[:, 64] = 0.0
    return dense


_NAN_TILES = {}


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("lane", [8, 12])
@pytest.mark.parametrize("strategy", ["fused", "partials", "stable"])
def test_max_propagates_nan_like_jax(strategy, lane, k):
    """Under the max monoid a NaN product of a live slot makes its output
    NaN, as ``jnp.max`` does in the JAX package, while a NaN reached only
    through padded slots stays masked: NaN positions equal, the rest
    bitwise."""
    if lane not in _NAN_TILES:
        _NAN_TILES[lane] = _pair(_nan_matrix(), lane)
    tj, dt = _NAN_TILES[lane]
    x_row = tj.colblock[:, None, None] * tj.cfg.col_block + tj.cols
    assert np.any((x_row == 64) & (tj.data == 0)) and not np.any((x_row == 64) & (tj.data != 0))
    rng = np.random.default_rng(20 + k)
    for row, probe in ((10, "live"), (40, "only"), (64, "padding")):
        X = rng.standard_normal((tj.shape[1], k)).astype(np.float32)
        X[row] = np.nan
        y_j = np.asarray(jops.hbp_spmm(tj, X, strategy=strategy, combine="max", interpret=True))
        y_t = tops.hbp_spmm(dt, X, strategy=strategy, combine="max").numpy()
        nan = np.isnan(y_j)
        np.testing.assert_array_equal(np.isnan(y_t), nan, err_msg=probe)
        np.testing.assert_array_equal(y_t[~nan].view(np.uint32), y_j[~nan].view(np.uint32),
                                      err_msg=probe)
        if probe == "live":
            assert np.all(np.isnan(y_t[20]))
        elif probe == "only":
            assert np.all(np.isnan(y_t[5]))  # NaN, not the 0 of a row with no live entry
        else:
            assert not nan.any()


@pytest.mark.parametrize("strategy", ["fused", "partials", "stable", "reference"])
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


@pytest.mark.parametrize("strategy", ["fused", "partials", "stable"])
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


@pytest.mark.parametrize("strategy", ["fused", "partials"])
def test_max_batch_width_and_padding_invariance_is_bitwise(tiles, strategy):
    """Under the max monoid a column's bits depend neither on the batch
    width, nor on bucket padding, nor on the k_tiling contract."""
    tj, dt = tiles
    rng = np.random.default_rng(12)
    x = rng.standard_normal((tj.shape[1], 1)).astype(np.float32)
    y1 = tops.hbp_spmm(dt, x, strategy=strategy, combine="max")[:, 0]
    for k in (5, 8, 200):
        X = rng.standard_normal((tj.shape[1], k)).astype(np.float32)
        X[:, k // 2] = x[:, 0]
        for kt in ("grid", "loop"):
            Y = tops.hbp_spmm(dt, X, strategy=strategy, combine="max", k_tiling=kt)
            assert torch.equal(Y[:, k // 2], y1), (k, kt)
        Yb = tops.hbp_spmm_bucketed(dt, X, strategy=strategy, combine="max")
        assert torch.equal(Yb[:, k // 2], y1), k


def test_plain_partials_and_max_wrappers(tiles):
    """The partials wrappers return one block per tile, the max wrappers
    -inf where a row has no live entry; the entry points map it to 0."""
    tj, dt = tiles
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal(tj.shape[1]).astype(np.float32))
    X = torch.as_tensor(rng.standard_normal((tj.shape[1], 4)).astype(np.float32))
    X[:, 2] = x
    p = hbp_spmv_partials(dt, x)
    assert p.shape == (tj.n_tiles, tj.cfg.group)
    P = hbp_spmm_partials(dt, X)
    assert P.shape == (tj.n_tiles, tj.cfg.group, 4) and torch.equal(P[..., 2], p)
    Pm = hbp_spmm_partials_max(dt, X)
    assert Pm.shape == P.shape
    Ym = hbp_spmm_fused_max(dt, X)
    assert Ym.shape == (tj.n_rowgroups, tj.cfg.group, 4)
    empty = np.setdiff1d(np.arange(tj.n_rowgroups), tj.rowgroup)
    assert torch.all(torch.isneginf(Ym[torch.as_tensor(empty, dtype=torch.long)]))
    # the run max of the per-tile maxima is the fused max
    assert torch.equal(tref.segment_max_sorted(Pm, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths), Ym)


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


def test_traffic_model_charges_the_partials_buffer(tiles):
    _, dt = tiles
    T, group = dt.n_tiles, dt.data.shape[1]
    for k in (1, 8, 256):
        # the fused bytes without the chunk index and the chunk buffer
        fused = tops.modeled_launch_bytes(dt, k, "fused", "grid")
        fused -= dt.chunk_index_nbytes + 2 * dt.chunk_buffer_nbytes(k)
        assert tops.modeled_launch_bytes(dt, k, "partials", "grid") == fused + 2 * T * group * k * 4


def test_traffic_model_charges_the_chunk_index_and_buffer(hub):
    """The fused kernels, sum and max alike, pay the chunk index once per
    stream pass and the split runs' chunk buffer written and read once,
    beyond what a strategy with neither ("stable") pays; the fused entry
    point records those bytes under either monoid."""
    _, dt = hub
    assert dt.n_split_chunks > 0
    for k, kt in ((1, "grid"), (8, "grid"), (256, "grid"), (256, "loop")):
        fused = tops.modeled_launch_bytes(dt, k, "fused", kt)
        plain = tops.modeled_launch_bytes(dt, k, "stable", kt)
        passes = tops.stream_passes(k, "fused", kt)
        assert dt.chunk_buffer_nbytes(k) == dt.n_split_chunks * 8 * k * 4
        assert fused - plain == passes * dt.chunk_index_nbytes + 2 * dt.chunk_buffer_nbytes(k)
    X = np.random.default_rng(14).standard_normal((dt.shape[1], 8)).astype(np.float32)
    obs.reset()
    obs.enable()
    try:
        for combine in ("sum", "max"):
            before = obs.registry().value("kernels.bytes_modeled")
            tops.hbp_spmm(dt, X, strategy="fused", combine=combine)
            recorded = obs.registry().value("kernels.bytes_modeled") - before
            assert recorded == tops.modeled_launch_bytes(dt, 8, "fused", "grid"), combine
    finally:
        obs.disable()
        obs.reset()


def test_deferred_paths_raise_not_implemented(tiles):
    """What stays deferred raises, naming its slice; partials and max are
    served."""
    _, dt = tiles
    X = np.ones((dt.shape[1], 2), np.float32)
    with pytest.raises(NotImplementedError, match="training slice.*ROADMAP"):
        tops.hbp_spmm_argmax(dt, X)
    assert tops.hbp_spmm(dt, X, strategy="partials").shape == (dt.shape[0], 2)
    assert tops.hbp_spmv(dt, X[:, 0], strategy="partials").shape == (dt.shape[0],)
    assert tops.hbp_spmm(dt, X, combine="max").shape == (dt.shape[0], 2)
    with pytest.raises(ValueError):
        tops.hbp_spmm(dt, X, strategy="bogus")
    with pytest.raises(ValueError):
        tops.hbp_spmm(dt, X, k_tiling="bogus")
    with pytest.raises(ValueError, match="combine"):
        tops.hbp_spmm(dt, X, combine="min")


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


# --- the chunk index of the fused kernels ------------------------------------


@pytest.fixture(scope="module")
def hub():
    """Tiles with a hub run of more than 4 * RUN_CHUNK tiles, runs of
    exactly RUN_CHUNK and RUN_CHUNK + 1 tiles, one-tile runs and empty row
    groups (tests/hub_runs.py), built by the JAX package and staged by the
    port."""
    rows, cols, vals, shape = hub_coo(tops.RUN_CHUNK, 8)
    csr = jcore.csr_from_coo(jcore.COOMatrix(rows, cols, vals, shape))
    geometry = {k: v for k, v in hub_config(8).items() if k != "lane"}
    return _pair_csr(csr, 8, **geometry)


def _runs(dt):
    return np.diff(dt.run_start.numpy())


def test_hub_matrix_has_the_runs_it_promises(hub):
    tj, dt = hub
    C = tops.RUN_CHUNK
    lengths = _runs(dt)
    assert lengths.max() > 4 * C
    assert {C, C + 1, 1} <= set(lengths.tolist())
    assert len(np.unique(tj.rowgroup)) < tj.n_rowgroups  # empty row groups


def test_chunks_tile_every_run_once_in_order(hub):
    _, dt = hub
    cs = dt.chunk_start.numpy()
    assert cs[0] == 0 and cs[-1] == dt.n_tiles
    assert np.all(np.diff(cs) >= 1)  # in stream order, none empty
    # every run boundary is a chunk boundary, so chunks cover each run once
    assert np.isin(dt.run_start.numpy(), cs).all()


def test_no_chunk_exceeds_run_chunk_or_crosses_a_run(hub):
    _, dt = hub
    cs = dt.chunk_start.numpy()
    assert np.diff(cs).max() <= tops.RUN_CHUNK
    run_of_first = np.searchsorted(dt.run_start.numpy(), cs[:-1], side="right") - 1
    run_of_last = np.searchsorted(dt.run_start.numpy(), cs[1:] - 1, side="right") - 1
    np.testing.assert_array_equal(run_of_first, run_of_last)


def test_run_chunk_agrees_with_run_start(hub):
    _, dt = hub
    rc, cs, rs = dt.run_chunk.numpy(), dt.chunk_start.numpy(), dt.run_start.numpy()
    assert rc.size == rs.size and rc[0] == 0 and rc[-1] == dt.chunk_dest.shape[0]
    np.testing.assert_array_equal(cs[rc], rs)
    np.testing.assert_array_equal(np.diff(rc), -(-_runs(dt) // tops.RUN_CHUNK))


def test_chunk_dest_and_split_runs(hub):
    """One-chunk runs write their row group; the chunks of split runs
    write consecutive chunk-buffer rows, in chunk order."""
    _, dt = hub
    rc, dest = dt.run_chunk.numpy(), dt.chunk_dest.numpy()
    split = np.flatnonzero(np.diff(rc) > 1)
    np.testing.assert_array_equal(dt.split_run.numpy(), split)
    whole = np.diff(rc) == 1
    np.testing.assert_array_equal(dest[rc[:-1][whole]], dt.run_rowgroup.numpy()[whole])
    buffer_rows = np.concatenate([np.arange(rc[r], rc[r + 1]) for r in split])
    np.testing.assert_array_equal(~dest[buffer_rows], np.arange(buffer_rows.size))
    assert dt.n_split_chunks == buffer_rows.size == np.count_nonzero(dest < 0)


def test_staged_bytes_count_the_chunk_index(hub):
    _, dt = hub
    assert dt.nbytes == sum(t.nbytes for t in dt.tensors())
    assert dt.chunk_index_nbytes == sum(
        t.nbytes for t in (dt.chunk_start, dt.run_chunk, dt.chunk_dest, dt.split_run)
    )


@pytest.mark.parametrize("limit", [1, 2, 3, 5, 8])
def test_chunk_index_at_any_limit(limit):
    """Balanced chunks of at most ``limit`` tiles, the fewest that fit."""
    lengths = np.array([1, 2, 3, 7, 8, 9, 16, 17, 40])
    run_start = np.concatenate([[0], np.cumsum(lengths)])
    run_rowgroup = np.arange(lengths.size) * 3 + 1
    cs, rc, dest, split = tops.chunk_index(run_start, run_rowgroup, limit)
    sizes = np.diff(cs)
    assert sizes.min() >= 1 and sizes.max() <= limit
    np.testing.assert_array_equal(cs[rc], run_start)
    n = np.diff(rc)
    np.testing.assert_array_equal(n, -(-lengths // limit))
    for r in range(lengths.size):  # near-equal within each run
        own = sizes[rc[r] : rc[r + 1]]
        assert own.max() - own.min() <= 1
    np.testing.assert_array_equal(split, np.flatnonzero(n > 1))
    np.testing.assert_array_equal(dest[rc[:-1][n == 1]], run_rowgroup[n == 1])


def test_empty_matrix_has_an_empty_chunk_index():
    _, dt = _pair(np.zeros((20, 30), np.float32), 8)
    assert dt.chunk_start.tolist() == [0] and dt.run_chunk.tolist() == [0]
    assert dt.chunk_dest.numel() == dt.split_run.numel() == dt.n_split_chunks == 0


@pytest.mark.parametrize("k", [None, 1, 8, 129])
def test_hub_fused_matches_jax(hub, k):
    """The CPU fused entry on the hub tiles against the JAX fused entry."""
    tj, dt = hub
    rng = np.random.default_rng(13)
    if k is None:
        x = rng.standard_normal(tj.shape[1]).astype(np.float32)
        y_j = jops.hbp_spmv(tj, x, strategy="fused", interpret=True)
        _close(tops.hbp_spmv(dt, x, strategy="fused", device="cpu"), y_j)
    else:
        X = rng.standard_normal((tj.shape[1], k)).astype(np.float32)
        y_j = jops.hbp_spmm(tj, X, strategy="fused", interpret=True)
        _close(tops.hbp_spmm(dt, X, strategy="fused", device="cpu"), y_j)


# --- the launch geometry of the tile-row kernel (kernels 3-6) ---------------


def _covered(geo, n_tiles, group, k):
    """Flat index ``(t * group + g) * k + c`` of every output element the
    tile-row kernel writes in launch geometry ``geo`` over ``n_tiles``
    items: the index arithmetic of ``hbp_rows_kernel``
    (``csrc/hbp_rows.cuh``) over every thread of the grid."""
    tile_threads = geo.slab * (group // geo.rows)
    by, bx, tid = np.meshgrid(np.arange(geo.grid[1]), np.arange(geo.grid[0]),
                              np.arange(geo.block), indexing="ij")
    j = tid % tile_threads
    t = bx * (geo.block // tile_threads) + tid // tile_threads
    c0 = (by * geo.slab + j % geo.slab) * geo.width
    g0 = j // geo.slab * geo.rows
    live = (t < n_tiles) & (c0 < k)
    t, g0, c0 = (a[live][:, None, None] for a in (t, g0, c0))
    r = np.arange(geo.rows)[None, :, None]
    w = np.arange(geo.width)[None, None, :]
    g, c = g0 + r, c0 + w
    assert np.all(g < group) and np.all(c < k)
    return ((t * group + g) * k + c).ravel()


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 12, 64, 128, 129, 136, 256, 300])
def test_partials_geometry_covers_every_output_once(k, aligned):
    """Every (tile, row, column) is written by exactly one thread, the
    vector path is taken exactly when k % 4 == 0 and the pointers are
    aligned, and a block fits the kernel's 256 threads, at the rows a
    thread the geometry picks for a tile and at the fused max's
    ``CHUNK_ROWS``.  The lane count does not enter the geometry (it is the
    kernel's compile-time specialisation)."""
    for group, n_tiles, rows in itertools.product((8, 4, 12, 1, 64), (1, 37),
                                                  (None, K.CHUNK_ROWS)):
        geo = partials_geometry(n_tiles, group, k, aligned, rows)
        assert rows is None or geo.rows == rows
        assert geo.width == (4 if aligned and k % 4 == 0 else 1)
        tile_threads = geo.slab * (group // geo.rows)
        assert group % geo.rows == 0 and geo.block <= 256
        assert geo.block % tile_threads == 0 and geo.grid[1] <= 65535
        counts = np.bincount(_covered(geo, n_tiles, group, k), minlength=n_tiles * group * k)
        assert counts.size == n_tiles * group * k and np.all(counts == 1), (group, n_tiles, rows)
    # at k = 128, two warps per tile: 64 threads of 4 columns and 4 rows
    geo = partials_geometry(10, 8, 128, True)
    assert (geo.width, geo.rows, geo.slab * 8 // geo.rows) == (4, 4, 64)


# --- the max kernels' launches in that geometry -------------------------------


def _offset(x):
    """``x``'s values in storage that starts one float past a 16-byte boundary."""
    y = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16
    return y


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("k", [1, 3, 8, 128, 129, 256])
@pytest.mark.parametrize("kernel", ["fused_max", "partials_max"])
def test_max_launch_geometry_writes_every_output_once(hub, monkeypatch, kernel, k, aligned):
    """The geometry the max wrappers hand their launchers covers every
    (chunk, g, c) of the fused max, or (tile, g, c) of the partials max,
    exactly once, on the vector path iff k % 4 == 0 and x is aligned; the
    fused max's chunks write each one-chunk run's row group and each
    chunk-buffer row once, and no row group of a split run."""
    _, dt = hub
    launched = []
    monkeypatch.setattr(K, "_launch", lambda lib, fn, tensors, dt_, x, counts, *tail:
                        launched.append((fn, counts, tail)))
    X = torch.randn(dt.shape[1], k, generator=torch.Generator().manual_seed(k))
    X = X if aligned else _offset(X)
    group = dt.data.shape[1]
    if kernel == "fused_max":
        K._fused_max(dt, X, torch.empty((dt.n_rowgroups, group, k)))
        n_items = dt.chunk_dest.shape[0]
    else:
        K._partials_launch("hbp_spmm_partials_max_launch", dt, X, torch.empty((dt.n_tiles, group, k)), k)
        n_items = dt.n_tiles
    (fn, counts, tail), = launched
    assert fn == f"hbp_spmm_{kernel}_launch" and counts[0] == n_items and tail[0] == k
    geo = PartialsGeometry(*tail[1:5], tuple(tail[5:]))
    assert geo.width == (4 if aligned and k % 4 == 0 else 1) and geo.block <= 256
    covered = _covered(geo, n_items, group, k)
    counts = np.bincount(covered, minlength=n_items * group * k)
    assert counts.size == n_items * group * k and np.all(counts == 1)
    if kernel == "fused_max":
        dest = dt.chunk_dest.numpy()
        rows = dest[covered // (group * k)]
        y_rows, buf_rows = np.unique(rows[rows >= 0]), np.unique(~rows[rows < 0])
        np.testing.assert_array_equal(buf_rows, np.arange(dt.n_split_chunks))
        assert y_rows.size == np.count_nonzero(dest >= 0)
        split_groups = dt.run_rowgroup.numpy()[dt.split_run.numpy()]
        assert dt.split_run.numel() and not np.isin(split_groups, y_rows).any()
