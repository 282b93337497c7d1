"""The port's CUDA kernels on the card (``-m gpu``; they skip without one).

Whether a card is present is decided inside the ``cuda`` fixture, never
at import or collection time, so every test process collects the same
tests.  Each sum kernel is held against its plain PyTorch version on the
same inputs with ``rtol=1e-5, atol=1e-5 * max(1, |y_plain|_inf)`` (the
kernel fuses each multiply-add), each max kernel exactly (the max is exact
in any order), and the bitwise invariants the serving engine relies on
are checked on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import COOMatrix, PartitionConfig, build_tiles, csr_from_coo, csr_from_dense
from repro_torch.core.matrices import banded_fem, circuit, rmat
from repro_torch.kernels import ops, ref
from repro_torch.kernels.hbp_spmv import (
    hbp_spmm_fused,
    hbp_spmm_fused_max,
    hbp_spmm_fused_max_plain,
    hbp_spmm_fused_plain,
    hbp_spmm_partials,
    hbp_spmm_partials_max,
    hbp_spmm_partials_max_plain,
    hbp_spmm_partials_plain,
    hbp_spmv_fused,
    hbp_spmv_fused_plain,
    hbp_spmv_partials,
    hbp_spmv_partials_plain,
)

from hub_runs import ZERO_CONFIG, hub_config, hub_coo, signed_zero_coo

pytestmark = pytest.mark.gpu

MATRICES = {
    "circuit": lambda: circuit(3000, seed=1),
    "rmat": lambda: rmat(1 << 12, 60_000, seed=2),
    "banded": lambda: banded_fem(2000, seed=3),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(y, y_plain):
    atol = 1e-5 * max(1.0, y_plain.abs().max().item())
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=atol)


def _staged(cuda, name, lane):
    cfg = PartitionConfig(row_block=256, col_block=1024, group=8, lane=lane)
    return ops.device_tiles(build_tiles(MATRICES[name](), cfg), cuda)


@pytest.mark.parametrize("lane", [8, 16, 128, 12])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernels_match_plain_and_spmv_is_the_spmm_column(cuda, name, lane):
    dt = _staged(cuda, name, lane)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    y = hbp_spmv_fused(dt, x)
    _close(y, hbp_spmv_fused_plain(dt, x))
    for k in (1, 3, 8, 128, 129, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x
        Y = hbp_spmm_fused(dt, X)
        _close(Y, hbp_spmm_fused_plain(dt, X))
        assert torch.equal(Y[..., k // 2], y), k


@pytest.mark.parametrize("lane", [8, 128, 12])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_max_and_partials_kernels_match_plain(cuda, name, lane):
    """Kernels 3-6 against their plain versions: sums within the
    tolerance, maxima exactly; the partials SpMV is bitwise the partials
    SpMM column."""
    dt = _staged(cuda, name, lane)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    p = hbp_spmv_partials(dt, x)
    _close(p, hbp_spmv_partials_plain(dt, x))
    for k in (1, 3, 8, 128, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x
        P = hbp_spmm_partials(dt, X)
        _close(P, hbp_spmm_partials_plain(dt, X))
        assert torch.equal(P[..., k // 2], p), k
        # bit patterns: torch.equal would let -0.0 pass for +0.0
        assert torch.equal(hbp_spmm_fused_max(dt, X).view(torch.int32),
                           hbp_spmm_fused_max_plain(dt, X).view(torch.int32)), k
        assert torch.equal(hbp_spmm_partials_max(dt, X).view(torch.int32),
                           hbp_spmm_partials_max_plain(dt, X).view(torch.int32)), k
        assert torch.equal(hbp_spmm_partials_max(dt, X, runs=True).view(torch.int32),
                           hbp_spmm_partials_max_plain(dt, X, runs=True).view(torch.int32)), k


@pytest.mark.parametrize("group", [1, 2, 8])
def test_partials_max_run_combine_on_both_paths(cuda, group):
    """Kernel 4 with its run combine kernel equals the plain segment max
    bitwise on the combine's scalar path (group * k not a multiple of 4)
    and its float4 path, with runs long enough to be split into chunks."""
    cfg = PartitionConfig(row_block=64, col_block=128, group=group, lane=4)
    dt = ops.device_tiles(build_tiles(rmat(1 << 11, 40_000, seed=8), cfg), cuda)
    assert dt.n_split_chunks > 0
    g = torch.Generator(device=cuda).manual_seed(12)
    for k in (1, 2, 3, 4, 129):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[::5] = 0.0
        X[1::5] = -0.0
        _same_bits(hbp_spmm_partials_max(dt, X, runs=True),
                   hbp_spmm_partials_max_plain(dt, X, runs=True), (group, k))


@pytest.mark.parametrize("k", [1, 4, 8, 128])
@pytest.mark.parametrize("sign", [0.0, -0.0], ids=["x+0", "x-0"])
def test_max_ranks_positive_zero_above_negative_zero_on_the_card(cuda, sign, k):
    """The signed-zero probe: ``-0.0`` and ``+0.0`` products meet in lane
    order, in tile order and across a split run's chunks; kernels 3-4, the
    run combine and every entry point give IEEE's maximum (``+0.0``)."""
    rows, cols, vals, shape, want = signed_zero_coo()
    dt = ops.device_tiles(build_tiles(csr_from_coo(COOMatrix(rows, cols, vals, shape)),
                                      PartitionConfig(**ZERO_CONFIG)), cuda)
    X = torch.full((shape[1], k), sign, device=cuda)
    want = np.zeros_like(want) if np.signbit(sign) else want
    want_t = torch.as_tensor(np.repeat(want[:, None], k, 1), device=cuda).view(torch.int32)

    def bits(y_hashed):
        # rows with no live entry hold the identity -inf; they come out 0
        y_hashed = y_hashed.masked_fill(torch.isneginf(y_hashed), 0.0)
        return ref.unpermute(y_hashed, dt.perm, shape[0]).view(torch.int32)

    assert torch.equal(bits(hbp_spmm_fused_max(dt, X)), want_t)
    P = hbp_spmm_partials_max(dt, X)
    assert torch.equal(bits(ref.segment_max_sorted(P, dt.rowgroup, dt.n_rowgroups,
                                                   dt.rg_lengths)), want_t)
    assert torch.equal(bits(hbp_spmm_partials_max(dt, X, runs=True)), want_t)
    for strategy in ("fused", "partials", "stable", "reference"):
        y = ops.hbp_spmm(dt, X, strategy=strategy, combine="max")
        assert torch.equal(y.view(torch.int32), want_t), strategy


def test_launch_counters_count_launches_only(cuda):
    dt = _staged(cuda, "circuit", 8)
    x = torch.ones(dt.shape[1], device=cuda)
    X = x[:, None].repeat(1, 4)
    wrappers = (
        (hbp_spmv_fused, x), (hbp_spmm_fused, X), (hbp_spmm_fused_max, X),
        (hbp_spmv_partials, x), (hbp_spmm_partials, X), (hbp_spmm_partials_max, X),
    )
    before = [w.launches for w, _ in wrappers]
    for w, arg in wrappers:
        w(dt, arg)
    hbp_spmv_fused_plain(dt, x)
    hbp_spmm_partials_max_plain(dt, X)
    hbp_spmm_partials_max_plain(dt, X, runs=True)
    assert [w.launches for w, _ in wrappers] == [n + 1 for n in before]
    # the partials max with its run combine is one launch call
    hbp_spmm_partials_max(dt, X, runs=True)
    assert hbp_spmm_partials_max.launches == before[-1] + 2


@pytest.mark.parametrize("strategy", ["fused", "partials", "stable"])
def test_bitwise_invariants_on_the_card(cuda, strategy):
    dt = _staged(cuda, "rmat", 8)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    y1 = ops.hbp_spmv(dt, x, strategy=strategy)
    for k in (1, 5, 8, 128, 200):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x
        assert torch.equal(ops.hbp_spmm_bucketed(dt, X, strategy=strategy)[:, k // 2], y1)
        for kt in ("grid", "loop"):
            Y = ops.hbp_spmm(dt, X, strategy=strategy, k_tiling=kt)
            assert torch.equal(Y[:, k // 2], y1), (k, kt)


def test_max_is_exact_across_strategies_on_the_card(cuda):
    """The max monoid gives one answer on every strategy, equal to a numpy
    f32 max of ``a * x`` over each row's stored nonzeros; all-negative
    rows stay negative and empty rows are 0."""
    rng = np.random.default_rng(4)
    dense = rng.standard_normal((512, 300)) * (rng.random((512, 300)) < 0.05)
    dense[64:320] = 0.0  # empty row groups
    dense[400] = -np.abs(dense[400]) - (dense[400] != 0)  # all-negative row
    dense[400, :3] = -2.0
    from repro_torch.core import csr_from_dense

    tiles = build_tiles(
        csr_from_dense(dense.astype(np.float32)),
        PartitionConfig(row_block=128, col_block=128, lane=8),
    )
    dt = ops.device_tiles(tiles, cuda)
    X = rng.standard_normal((300, 40)).astype(np.float32)
    X[:, 0] = np.abs(X[:, 0]) + 0.1  # every product of row 400 is negative here
    a = dense.astype(np.float32)
    prod = np.where(a[:, :, None] != 0, a[:, :, None] * X[None], -np.inf).max(axis=1)
    want = np.where(np.isneginf(prod), 0.0, prod).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda)
    ys = {
        s: ops.hbp_spmm(dt, Xd, strategy=s, combine="max")
        for s in ("fused", "partials", "stable")
    }
    for s, y in ys.items():
        assert np.array_equal(y.cpu().numpy(), want), s
    assert float(ys["fused"][400, 0]) < 0 and bool(torch.all(ys["fused"][64:320] == 0))
    Xb = torch.as_tensor(rng.standard_normal((300, 5)).astype(np.float32), device=cuda)
    for s in ("fused", "partials"):
        y5 = ops.hbp_spmm_bucketed(dt, Xb, strategy=s, combine="max")
        assert torch.equal(y5, ops.hbp_spmm(dt, Xb, strategy="stable", combine="max")), s


def test_empty_row_groups_are_zero_on_the_card(cuda):
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((512, 300)) * (rng.random((512, 300)) < 0.05)
    dense[64:320] = 0.0
    from repro_torch.core import csr_from_dense

    tiles = build_tiles(csr_from_dense(dense), PartitionConfig(row_block=128, col_block=128, lane=8))
    empty = np.setdiff1d(np.arange(tiles.n_rowgroups), tiles.rowgroup)
    assert empty.size
    dt = ops.device_tiles(tiles, cuda)
    X = torch.randn(300, 8, device=cuda)
    y_h = hbp_spmm_fused(dt, X)
    assert torch.all(y_h[torch.as_tensor(empty, device=cuda)] == 0)
    Y = ops.hbp_spmm(dt, X)
    _close(Y, torch.as_tensor(dense, dtype=torch.float32, device=cuda) @ X)


@pytest.mark.parametrize("strategy", [None, "partials"])
def test_served_answers_equal_matvec_on_the_card(cuda, tmp_path, strategy):
    from repro_torch.serving import MatrixRegistry, ServingEngine

    reg = MatrixRegistry(cache_dir=tmp_path, search=False, strategy=strategy)
    assert reg.strategy == (strategy or "fused") and reg.device.type == "cuda"
    A = circuit(5000, seed=3)
    plan = reg.admit(A, "a")
    rng = np.random.default_rng(1)
    for overlap in (False, True):
        eng = ServingEngine(reg, max_batch=16, overlap=overlap)
        xs = [rng.standard_normal(A.shape[1]).astype(np.float32) for _ in range(37)]
        tickets = [eng.submit("a", x) for x in xs]
        eng.poll()
        for x, t in zip(xs, tickets):
            assert np.array_equal(t.result(), plan.matvec(x).cpu().numpy())
        assert eng.inflight() == 0


# --- the chunked fused sum kernels on runs longer than RUN_CHUNK ------------


def _hub(cuda, lane):
    rows, cols, vals, shape = hub_coo(ops.RUN_CHUNK, lane)
    tiles = build_tiles(csr_from_coo(COOMatrix(rows, cols, vals, shape)),
                        PartitionConfig(**hub_config(lane)))
    dt = ops.device_tiles(tiles, cuda)
    lengths = np.diff(dt.run_start.cpu().numpy())
    assert lengths.max() > 4 * ops.RUN_CHUNK and dt.n_split_chunks > 0
    return tiles, dt


@pytest.mark.parametrize("lane", [8, 128, 12])
def test_hub_runs_match_plain_and_spmv_is_the_spmm_column(cuda, lane):
    """Split runs (chunk chains, then the ordered fold) against the plain
    versions; SpMV bitwise the SpMM column at every width."""
    _, dt = _hub(cuda, lane)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    y = hbp_spmv_fused(dt, x)
    _close(y, hbp_spmv_fused_plain(dt, x))
    for k in (1, 3, 8, 128, 129, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x
        Y = hbp_spmm_fused(dt, X)
        _close(Y, hbp_spmm_fused_plain(dt, X))
        assert torch.equal(Y[..., k // 2], y), k


@pytest.mark.parametrize("lane", [8, 128, 12])
def test_hub_runs_grid_equals_loop_and_empty_groups_are_zero(cuda, lane):
    tiles, dt = _hub(cuda, lane)
    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn(dt.shape[1], 256, device=cuda, generator=g)
    assert torch.equal(ops.hbp_spmm(dt, X, k_tiling="grid"), ops.hbp_spmm(dt, X, k_tiling="loop"))
    empty = torch.as_tensor(np.setdiff1d(np.arange(tiles.n_rowgroups), tiles.rowgroup),
                            device=cuda)
    assert empty.numel()
    assert bool(torch.all(hbp_spmm_fused(dt, X[:, :8].contiguous())[empty] == 0))
    assert bool(torch.all(hbp_spmv_fused(dt, X[:, 0].contiguous())[empty] == 0))


def test_hub_fused_launch_counters_count_launches_only(cuda):
    """One wrapper call is one count, though the split runs take a second
    kernel (the fold); the plain versions count nothing."""
    _, dt = _hub(cuda, 8)
    x = torch.ones(dt.shape[1], device=cuda)
    X = x[:, None].repeat(1, 8)
    before = (hbp_spmv_fused.launches, hbp_spmm_fused.launches)
    hbp_spmv_fused(dt, x)
    hbp_spmm_fused(dt, X)
    hbp_spmv_fused_plain(dt, x)
    hbp_spmm_fused_plain(dt, X)
    assert (hbp_spmv_fused.launches, hbp_spmm_fused.launches) == (before[0] + 1, before[1] + 1)


# --- the partials sum kernels' vector and scalar-column paths ---------------


def _offset(x):
    """``x``'s values in storage that starts one float past a 16-byte boundary."""
    y = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16
    return y


@pytest.mark.parametrize("lane", [8, 16, 32, 64, 128, 12])
def test_partials_paths_give_one_chain_per_column(cuda, lane):
    """Kernels 5-6 at widths on both paths (vector: k % 4 == 0 and x
    aligned; scalar-column: any other k, or x offset by one float) against
    the plain versions; one x column gets the same bits at every width
    and on both paths, and the SpMV partials are that column."""
    dt = _staged(cuda, "rmat", lane)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    p = hbp_spmv_partials(dt, x)
    _close(p, hbp_spmv_partials_plain(dt, x))
    assert torch.equal(hbp_spmv_partials(dt, _offset(x)), p)
    for k in (1, 2, 3, 4, 8, 128, 129, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x
        P = hbp_spmm_partials(dt, X)
        _close(P, hbp_spmm_partials_plain(dt, X))
        assert torch.equal(P[..., k // 2], p), k
        assert torch.equal(hbp_spmm_partials(dt, _offset(X)), P), k


@pytest.mark.parametrize("lane", [8, 128, 12])
def test_partials_keep_padded_slots_in_the_chain(cuda, lane):
    """A tile row whose lanes are all padding comes out 0 for a finite x,
    and NaN once x's first row of each column block (the padded slots'
    column 0) is infinite: 0 * inf, as on the TPU, so padded slots are
    never skipped."""
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((256, 200)) * (rng.random((256, 200)) < 0.05)
    dense[::3] = 0.0  # empty rows: tile rows of padding only
    cfg = PartitionConfig(row_block=64, col_block=64, lane=lane)
    tiles = build_tiles(csr_from_dense(dense.astype(np.float32)), cfg)
    padding = torch.as_tensor((tiles.data != 0).sum(-1) == 0, device=cuda)
    assert padding.any()
    dt = ops.device_tiles(tiles, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    for k in (1, 3, 8, 128):
        X = torch.randn(200, k, device=cuda, generator=g)
        P = hbp_spmm_partials(dt, X)
        assert bool(torch.all(P[padding] == 0)), k
        X[::64] = float("inf")
        P = hbp_spmm_partials(dt, X)
        assert bool(torch.all(torch.isnan(P[padding]))), k
        torch.testing.assert_close(P, hbp_spmm_partials_plain(dt, X), equal_nan=True,
                                   rtol=1e-5, atol=1e-5 * max(1.0, P.nan_to_num(0, 0, 0).abs().max().item()))
        if k == 1:
            p = hbp_spmv_partials(dt, X[:, 0].contiguous())
            assert bool(torch.all(torch.isnan(p[padding])))


# --- the max kernels (3-4) on the tile-row geometry, and NaN -----------------


def _same_bits(y, y_plain, what=""):
    """NaN in the same places, every other element bitwise equal."""
    nan = torch.isnan(y_plain)
    assert torch.equal(torch.isnan(y), nan), what
    assert torch.equal(y[~nan].view(torch.int32), y_plain[~nan].view(torch.int32)), what


@pytest.mark.parametrize("lane", [8, 16, 32, 64, 128, 12])
def test_max_kernels_equal_plain_on_both_paths(cuda, lane):
    """Kernels 3-4 at widths on both column paths (vector: k % 4 == 0 and
    x aligned; scalar: any other k, or x offset by one float) exactly
    equal to their plain versions; a column's bits do not depend on the
    width or the path."""
    dt = _staged(cuda, "rmat", lane)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(dt.shape[1], 1, device=cuda, generator=g)
    ref = {name: fn(dt, x) for name, fn in (("fused", hbp_spmm_fused_max),
                                            ("partials", hbp_spmm_partials_max))}
    for k in (1, 2, 3, 4, 8, 128, 129, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x[:, 0]
        for name, kern, plain in (("fused", hbp_spmm_fused_max, hbp_spmm_fused_max_plain),
                                  ("partials", hbp_spmm_partials_max,
                                   hbp_spmm_partials_max_plain)):
            Y = kern(dt, X)
            _same_bits(Y, plain(dt, X), (name, k))
            _same_bits(kern(dt, _offset(X)), Y, (name, k, "offset"))
            _same_bits(Y[..., k // 2], ref[name][..., 0], (name, k, "column"))


@pytest.mark.parametrize("lane", [8, 128, 12])
def test_hub_max_kernels_equal_plain_and_fold_split_runs(cuda, lane):
    """Runs longer than 4 * RUN_CHUNK: the max chunk chains and their fold
    exactly equal the plain versions; empty row groups stay -inf in the
    kernel's output and come out 0 from the entry point."""
    tiles, dt = _hub(cuda, lane)
    g = torch.Generator(device=cuda).manual_seed(9)
    for k in (1, 2, 3, 4, 8, 128, 129, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        for Xk in (X, _offset(X)):
            _same_bits(hbp_spmm_fused_max(dt, Xk), hbp_spmm_fused_max_plain(dt, X), k)
            _same_bits(hbp_spmm_partials_max(dt, Xk), hbp_spmm_partials_max_plain(dt, X), k)
            _same_bits(hbp_spmm_partials_max(dt, Xk, runs=True),
                       hbp_spmm_partials_max_plain(dt, X, runs=True), k)
    empty = torch.as_tensor(np.setdiff1d(np.arange(tiles.n_rowgroups), tiles.rowgroup),
                            device=cuda)
    assert empty.numel()
    X = torch.randn(dt.shape[1], 8, device=cuda, generator=g)
    assert bool(torch.all(torch.isneginf(hbp_spmm_fused_max(dt, X)[empty])))
    assert bool(torch.all(torch.isneginf(hbp_spmm_partials_max(dt, X, runs=True)[empty])))
    Y = ops.hbp_spmm(dt, X, combine="max")
    for s in ("partials", "stable"):
        assert torch.equal(ops.hbp_spmm(dt, X, strategy=s, combine="max"), Y), s
    assert bool(torch.all(ops.hbp_spmm_bucketed(dt, X[:, :5], combine="max") == Y[:, :5]))


def _nan_tiles(cuda, name):
    if name == "hub":
        return _hub(cuda, 8)
    if name == "rmat":
        cfg = PartitionConfig(row_block=256, col_block=1024, group=8, lane=8)
        tiles = build_tiles(MATRICES["rmat"](), cfg)
    else:  # the first column of every block empty: reached by padding only
        rng = np.random.default_rng(11)
        dense = rng.standard_normal((256, 200)) * (rng.random((256, 200)) < 0.05)
        dense[::3] = 0.0
        dense[:, ::64] = 0.0
        tiles = build_tiles(csr_from_dense(dense.astype(np.float32)),
                            PartitionConfig(row_block=64, col_block=64, lane=8))
    return tiles, ops.device_tiles(tiles, cuda)


@pytest.mark.parametrize("name", ["rmat", "hub", "holes"])
def test_max_carries_nan_on_the_card(cuda, name):
    """A NaN in x reached by a live slot gives NaN through kernels 3-4, the
    fused max's fold, the partials max combine (``segment_reduce``, and
    the combine kernel of ``runs=True``) and both entry points, where the plain versions and "stable" give it; a
    NaN reached only by padded slots changes nothing."""
    tiles, dt = _nan_tiles(cuda, name)
    x_row = tiles.colblock[:, None, None].astype(np.int64) * tiles.cfg.col_block + tiles.cols
    live = np.unique(x_row[tiles.data != 0])
    padding_only = torch.as_tensor(
        np.setdiff1d(np.unique(x_row[tiles.data == 0]), live), device=cuda)
    assert padding_only.numel() or name != "holes"
    runs = list(zip(dt.run_rowgroup.tolist(), dt.run_start[:-1].tolist(),
                    dt.run_start[1:].tolist()))
    g = torch.Generator(device=cuda).manual_seed(10)
    rng = np.random.default_rng(10)
    for k in (1, 3, 8, 128):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[torch.as_tensor(rng.choice(live, 3, replace=False), device=cuda)] = float("nan")
        X[padding_only] = float("nan")
        Yf = hbp_spmm_fused_max(dt, X)
        assert bool(torch.isnan(Yf).any()), k
        _same_bits(Yf, hbp_spmm_fused_max_plain(dt, X), ("fused", k))
        P = hbp_spmm_partials_max(dt, X)
        _same_bits(P, hbp_spmm_partials_max_plain(dt, X), ("partials", k))
        # the combine alone carries NaN on the card: each run's amax
        want = torch.full((dt.n_rowgroups,) + P.shape[1:], float("-inf"), device=cuda)
        for rg, a, b in runs:
            want[rg] = P[a:b].amax(0)
        _same_bits(ref.segment_max_sorted(P, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths),
                   want, ("combine", k))
        _same_bits(hbp_spmm_partials_max(dt, X, runs=True), want, ("combine kernel", k))
        stable = ops.hbp_spmm(dt, X, strategy="stable", combine="max")
        for s in ("fused", "partials"):
            _same_bits(ops.hbp_spmm(dt, X, strategy=s, combine="max"), stable, (s, k))
        X[padding_only] = 0.0
        _same_bits(hbp_spmm_fused_max(dt, X), Yf, ("padding only", k))
        _same_bits(hbp_spmm_partials_max(dt, X), P, ("padding only", k))


@pytest.mark.parametrize("passes", [1, 3])
def test_argmax_on_the_card_equals_the_cpu(cuda, passes):
    """The argmax SpMM is exact torch code: the card gives the CPU's
    triple bit for bit (NaN positions included)."""
    tiles = build_tiles(MATRICES["rmat"](), PartitionConfig(row_block=256, col_block=1024,
                                                           group=8, lane=8))
    dt, dt_cpu = ops.device_tiles(tiles, cuda), ops.device_tiles(tiles, "cpu")
    g = torch.Generator(device=cuda).manual_seed(12)
    for k in (1, 8, 128):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, 0] = torch.round(X[:, 0])  # ties
        X[5] = float("nan")
        for a, b in zip(ops.hbp_spmm_argmax(dt, X, passes=passes),
                        ops.hbp_spmm_argmax(dt_cpu, X.cpu(), passes=passes)):
            a = a.cpu()
            if a.is_floating_point():
                assert torch.equal(torch.isnan(a), torch.isnan(b)), k
                a, b = torch.nan_to_num(a), torch.nan_to_num(b)
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), k


@pytest.mark.parametrize("strategy,kernel", [("fused", hbp_spmm_fused),
                                             ("partials", hbp_spmm_partials)])
def test_backward_is_the_transpose_kernel(cuda, tmp_path, strategy, kernel):
    """The sum and mean backward on a registry pair launches kernel 2
    (fused) or 6 (partials) on the Aᵀ tiles, and agrees with the CPU."""
    from repro_torch.graph import plan_diff_aggregator, power_law_graph
    from repro_torch.serving import MatrixRegistry

    adj = power_law_graph(3000, 8.0, seed=5, symmetric=False)
    reg = MatrixRegistry(device=cuda, cache_dir=tmp_path / "c", search=False, strategy=strategy)
    ref_reg = MatrixRegistry(device="cpu", cache_dir=tmp_path / "r", search=False)
    plan, plan_cpu = reg.admit_pair(adj), ref_reg.admit_pair(adj)
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(3000, 64, device=cuda, generator=g)
    y_bar = torch.randn(3000, 64, device=cuda, generator=g)
    for op in ("sum", "mean", "max"):
        xr = x.clone().requires_grad_(True)
        y = plan_diff_aggregator(plan, op=op)(xr)
        before = kernel.launches
        (x_bar,) = torch.autograd.grad(y, xr, y_bar[:, :].T.contiguous().T)  # strided
        if op != "max":
            assert kernel.launches > before, op
        xc = x.cpu().requires_grad_(True)
        (x_bar_cpu,) = torch.autograd.grad(plan_diff_aggregator(plan_cpu, op=op)(xc), xc,
                                           y_bar.cpu())
        _close(x_bar.cpu(), x_bar_cpu)


@pytest.mark.parametrize("strategy", ["fused", "partials"])
def test_kernel_aggregators_refuse_to_differentiate(cuda, strategy):
    """The kernels record no autograd graph: a GCN layer over the ordinary
    aggregator raises under grad mode instead of leaving W without a
    gradient, runs under no_grad, and trains through the differentiable
    twin, whose gradients are the CPU chain's."""
    from repro_torch.graph import GCN, make_aggregator, make_diff_aggregator, power_law_graph

    adj = power_law_graph(2000, 8.0, seed=7)
    gcn = GCN([16, 8], generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    x = torch.randn(2000, 16, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    for op in ("sum", "max"):
        agg = make_aggregator(adj, op=op, strategy=strategy, device=cuda)
        with pytest.raises(RuntimeError, match="make_diff_aggregator"):
            gcn(agg, x)
        with pytest.raises(RuntimeError, match="make_diff_aggregator"):
            agg(x.clone().requires_grad_(True))
        with torch.no_grad():
            assert torch.isfinite(gcn(agg, x)).all()
        gcn.zero_grad()
        gcn(make_diff_aggregator(adj, op=op, strategy=strategy, device=cuda), x).sum().backward()
        grads = [p.grad.cpu() for p in gcn.parameters()]
        cpu = GCN.from_params([tuple(f.detach().cpu().numpy() for f in p) for p in gcn.params()])
        cpu(make_diff_aggregator(adj, op=op, device="cpu"), x.cpu()).sum().backward()
        for got, p in zip(grads, cpu.parameters()):
            _close(got, p.grad)


def test_training_on_the_card_matches_the_cpu(cuda, tmp_path):
    from repro_torch.graph import power_law_graph
    from repro_torch.graph.train import NodeClassifierTrainer
    from repro_torch.serving import MatrixRegistry

    adj = power_law_graph(2000, 8.0, seed=6, symmetric=False)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    labels = rng.integers(0, 5, 2000)
    for model, op in (("gcn", "sum"), ("sage", "mean"), ("sage", "max")):
        hist = {}
        for strategy, dev in (("fused", cuda), ("partials", cuda), ("stable", "cpu")):
            reg = MatrixRegistry(device=dev, cache_dir=tmp_path / strategy, search=False,
                                 strategy=strategy)
            trainer = NodeClassifierTrainer([32, 64, 5], model=model, op=op, registry=reg)
            _, h = trainer.fit(adj, x, labels, steps=3, key=3)
            hist[strategy] = np.array([m["loss"] for m in h])
        for strategy in ("fused", "partials"):
            np.testing.assert_allclose(hist[strategy], hist["stable"], rtol=1e-4)
