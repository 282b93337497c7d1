"""The port's CUDA kernels on the card (``-m gpu``; they skip without one).

Whether a card is present is decided inside the ``cuda`` fixture, never
at import or collection time, so every test process collects the same
tests.  Each sum kernel is held against its plain PyTorch version on the
same inputs with ``rtol=1e-5, atol=1e-5 * max(1, |y_plain|_inf)`` (the
kernel fuses each multiply-add), each max kernel exactly (the max is exact
in any order), and the bitwise invariants the serving engine relies on
are checked on the card.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import COOMatrix, PartitionConfig, build_tiles, csr_from_coo, csr_from_dense
from repro_torch.core.matrices import banded_fem, circuit, rmat
from repro_torch.kernels import ops, ref
from repro_torch.kernels.hbp_spmv import (
    hbp_spmm_fused,
    hbp_spmm_fused_argmax,
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
        Y = ops.hbp_spmm(dt, X, strategy=strategy)
        assert torch.equal(Y[:, k // 2], y1), k


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
def test_hub_runs_wide_k_equals_its_column_blocks_and_empty_groups_are_zero(cuda, lane):
    """One call at k = 256 gives the bits of two 128-wide calls side by
    side (each column is computed on its own), and row groups without
    tiles come out 0."""
    tiles, dt = _hub(cuda, lane)
    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn(dt.shape[1], 256, device=cuda, generator=g)
    halves = [ops.hbp_spmm(dt, X[:, lo:lo + 128].contiguous()) for lo in (0, 128)]
    assert torch.equal(ops.hbp_spmm(dt, X), torch.cat(halves, dim=1))
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


@pytest.mark.parametrize("lane", [8, 128, 12])
def test_fused_sum_column_widths_on_hub_runs(cuda, lane):
    """Kernel 2 on the tile-row walk at the GCN and GAT cells' widths, on
    split runs: float4 columns (k = 40, 256), float2 (k = 250, and k = 256
    with x 8 bytes past a 16-byte boundary) and scalar columns (x one float
    past it) against the plain version; the three paths give one x the
    same bits, SpMV is bitwise each width's column, and the rows of row
    groups with no tiles come out 0."""
    tiles, dt = _hub(cuda, lane)
    empty = torch.as_tensor(np.setdiff1d(np.arange(tiles.n_rowgroups), tiles.rowgroup),
                            device=cuda)
    assert empty.numel()
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    y = hbp_spmv_fused(dt, x)
    for k in (40, 250, 256):
        X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
        X[:, k // 2] = x
        Y = hbp_spmm_fused(dt, X)
        _close(Y, hbp_spmm_fused_plain(dt, X))
        assert torch.equal(Y[..., k // 2], y), k
        assert bool(torch.all(Y[empty] == 0)), k
        for floats in (2, 1):
            assert torch.equal(hbp_spmm_fused(dt, _offset(X, floats)), Y), (k, floats)


def test_fused_sum_counts_its_launches_by_column_width(cuda, monkeypatch):
    """``kernels.fused_sum_launches{width}`` counts each launch of kernel 2
    once, under the column width the launch took, beside ``launches``; at
    k = 1 the launch is kernel 1's chain (the walk is not entered), with
    kernel 1's bits."""
    from repro_torch import obs

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    _, dt = _hub(cuda, 8)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(dt.shape[1], device=cuda, generator=g)
    walk = K._fused_sum

    def walk_above_one_column(dt_, x_, *args, **kwargs):
        assert x_.shape[1] > 1, "k = 1 entered the walk"
        return walk(dt_, x_, *args, **kwargs)

    monkeypatch.setattr(K, "_fused_sum", walk_above_one_column)
    assert torch.equal(hbp_spmm_fused(dt, x[:, None].contiguous())[..., 0],
                       hbp_spmv_fused(dt, x))
    cases = ((256, 0, 4), (40, 0, 4), (250, 0, 2), (256, 2, 2), (256, 1, 1), (3, 0, 1),
             (1, 0, 1), (1, 1, 1))
    obs.reset()
    obs.enable()
    try:
        for k, floats, width in cases:
            X = torch.randn(dt.shape[1], k, device=cuda, generator=g)
            X = _offset(X, floats) if floats else X
            before = [obs.registry().value("kernels.fused_sum_launches", width=w)
                      for w in (1, 2, 4)]
            launches = hbp_spmm_fused.launches
            hbp_spmm_fused(dt, X)
            hbp_spmm_fused_plain(dt, X)
            after = [obs.registry().value("kernels.fused_sum_launches", width=w)
                     for w in (1, 2, 4)]
            want = [int(w == width) for w in (1, 2, 4)]
            assert [a - b for a, b in zip(after, before)] == want, (k, floats)
            assert hbp_spmm_fused.launches == launches + 1
    finally:
        obs.disable()
        obs.reset()


# --- the partials sum kernels' vector and scalar-column paths ---------------


def _offset(x, floats=1):
    """``x``'s values in storage that starts ``floats`` floats past a
    16-byte boundary."""
    y = torch.empty(x.numel() + floats, device=x.device)[floats:].view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 4 * floats
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


def _argmax_cases(cuda):
    """``(name, tiles, staged tiles)`` of the argmax tests: R-MAT at lane 8
    and at a lane the generic loop takes (12), the hub matrix at both (runs
    split into several chunks, so the fold runs; empty row groups), and the
    signed-zero matrix (ties of ``+0.0`` and ``-0.0`` in lane, tile and
    chunk order)."""
    for lane in (8, 12):
        cfg = PartitionConfig(row_block=256, col_block=1024, group=8, lane=lane)
        tiles = build_tiles(MATRICES["rmat"](), cfg)
        yield f"rmat-{lane}", tiles, ops.device_tiles(tiles, cuda)
        tiles, dt = _hub(cuda, lane)
        yield f"hub-{lane}", tiles, dt
    rows, cols, vals, shape, _ = signed_zero_coo()
    tiles = build_tiles(csr_from_coo(COOMatrix(rows, cols, vals, shape)),
                        PartitionConfig(**ZERO_CONFIG))
    yield "signed-zero", tiles, ops.device_tiles(tiles, cuda)


def _argmax_rhs(name, n, k, g):
    """x with ties, signed zeros, NaN rows and infinite entries (a live
    product of -inf keeps its column); on the signed-zero matrix zeros, so
    every product is a signed zero, with +inf at row 4's two columns in
    odd columns (only -inf products) and NaN at rows 0-1's column 3."""
    if name == "signed-zero":
        X = torch.zeros(n, k, device=g.device)
        X[7, 1::2] = X[70, 1::2] = float("inf")
        X[3, 2::3] = float("nan")
        return X
    X = torch.randn(n, k, device=g.device, generator=g)
    X[:, 0] = torch.round(X[:, 0])  # ties
    sign = torch.sign(torch.randn(n, device=g.device, generator=g))
    X[:, k // 2] = sign * 0.0  # +0.0 and -0.0
    X[5] = float("nan")
    X[9, ::2] = float("inf")
    X[11, 1::2] = float("-inf")
    return X


def _same_triple(got, want, what):
    """Equal bit patterns, NaN in the same places."""
    for a, b, name in zip(got, want, ("y", "idx", "coeff")):
        a = a.cpu()
        if a.is_floating_point():
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan), (what, name)
            a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
        assert torch.equal(a, b), (what, name)


@pytest.mark.parametrize("passes", [1, 3])
def test_argmax_on_the_card_equals_the_cpu(cuda, passes):
    """The card's argmax triple (the fused argmax kernel at ``passes=1``,
    the three-pass torch chain at 3) is the CPU's one-pass and three-pass
    torch chains' bit for bit: NaN positions and the sign of zero included,
    on both column paths (k = 1, 6 and an x offset from 16 bytes: one
    column a thread; k = 8, 128, 256: four), the unrolled and the generic
    lane loop, split runs folded across chunks, and row groups with no
    tiles."""
    g = torch.Generator(device=cuda).manual_seed(12)
    empty_rowgroups = 0
    for name, tiles, dt in _argmax_cases(cuda):
        dt_cpu = ops.device_tiles(tiles, "cpu")
        empty_rowgroups += tiles.n_rowgroups - np.unique(tiles.rowgroup).size
        for k in (1, 6, 8, 128, 256):
            X = _argmax_rhs(name, dt.shape[1], k, g)
            want = [ops.hbp_spmm_argmax(dt_cpu, X.cpu(), passes=p) for p in (1, 3)]
            for Xk in (X, _offset(X)) if k == 8 else (X,):
                got = ops.hbp_spmm_argmax(dt, Xk, passes=passes)
                for p, w in zip((1, 3), want):
                    _same_triple(got, w, (name, k, Xk.data_ptr() % 16, p))
    assert empty_rowgroups > 0


def test_argmax_kernel_counts_its_launches(cuda, tmp_path):
    """Each ``passes=1`` call of the argmax on the card launches the kernel
    once, counted by ``hbp_spmm_fused_argmax.launches`` and by
    ``kernels.launches{op=spmm_argmax, strategy=fused}``; ``passes=3``
    launches it never and is counted as ``"stable"``.  A SAGE-max train
    step launches it once a layer and walks the torch chain never."""
    from repro_torch import obs
    from repro_torch.graph import power_law_graph
    from repro_torch.graph.train import NodeClassifierTrainer
    from repro_torch.serving import MatrixRegistry

    tiles, dt = _hub(cuda, 8)
    X = torch.randn(dt.shape[1], 8, device=cuda)
    labels = dict(op="spmm_argmax", combine="max")
    obs.reset()
    obs.enable()
    try:
        for passes, counts in ((1, (1, 1, 0)), (3, (0, 0, 1)), (1, (1, 1, 0))):
            before = (hbp_spmm_fused_argmax.launches,
                      obs.registry().value("kernels.launches", strategy="fused", **labels),
                      obs.registry().value("kernels.launches", strategy="stable", **labels))
            ops.hbp_spmm_argmax(dt, X, passes=passes)
            after = (hbp_spmm_fused_argmax.launches,
                     obs.registry().value("kernels.launches", strategy="fused", **labels),
                     obs.registry().value("kernels.launches", strategy="stable", **labels))
            assert tuple(a - b for a, b in zip(after, before)) == counts, passes
    finally:
        obs.disable()
        obs.reset()
    adj = power_law_graph(2000, 8.0, seed=6, symmetric=False)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    y = rng.integers(0, 5, 2000)
    reg = MatrixRegistry(device=cuda, cache_dir=tmp_path / "c", search=False)
    trainer = NodeClassifierTrainer([32, 64, 64, 5], model="sage", op="max", registry=reg)
    trainer.fit(adj, x, y, steps=1, key=3)  # admission and the first step
    before = hbp_spmm_fused_argmax.launches
    with ref.count_traversals() as walks:
        trainer.fit(adj, x, y, steps=1, key=3)
    assert hbp_spmm_fused_argmax.launches - before == 3
    assert walks[0] == 0


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


@pytest.mark.parametrize("width", [250, 40])
def test_sddmm_kernel_matches_its_plain_version(cuda, width):
    """GAT's attention gradient on an R-MAT graph with hub rows (split over
    several warps' chunks) and empty rows, at the ogbn-arxiv GAT's head
    widths: the kernel's dot products against the plain version's, which
    adds them in another order."""
    from repro_torch.kernels.hbp_spmv import hbp_sddmm

    adj = rmat(1 << 12, 120_000, seed=8, symmetric=False)
    heads, n = 3, adj.shape[0]
    g = torch.Generator(device=cuda).manual_seed(16)
    dy = torch.randn((n, heads * width), device=cuda, generator=g)
    z = torch.randn((n, heads * width), device=cuda, generator=g)
    indptr = torch.as_tensor(adj.indptr, device=cuda)
    cols = torch.as_tensor(adj.indices, dtype=torch.int32, device=cuda)
    before = hbp_sddmm.launches
    got = hbp_sddmm(indptr, cols, dy, z, heads)
    torch.cuda.synchronize()
    assert hbp_sddmm.launches == before + 1
    want = ref.sddmm(indptr, cols, dy.double(), z.double(), heads)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5 * width ** 0.5)
    assert torch.equal(got, hbp_sddmm(indptr, cols, dy, z, heads))  # one order every launch


def _softmax_case(cuda, heads):
    """An R-MAT ``A + I`` with hub rows (above ``SOFTMAX_LONG_ROW``: a block
    each) and rows that are only their self-loop, its maps on the card,
    scores and a weight gradient in float32 ``[*, heads]``."""
    from repro_torch.graph import add_self_loops
    from repro_torch.kernels import autodiff
    from repro_torch.kernels.hbp_spmv import SOFTMAX_LONG_ROW

    adj = add_self_loops(rmat(1 << 12, 120_000, seed=8, symmetric=False))
    assert (np.diff(adj.indptr) > SOFTMAX_LONG_ROW).any() and (np.diff(adj.indptr) == 1).any()
    cfg = PartitionConfig(row_block=256, col_block=512, group=8, lane=8)
    maps = autodiff.attention_maps(adj, build_tiles(adj, cfg), build_tiles(adj.transpose(), cfg),
                                   cuda)
    g = torch.Generator(device=cuda).manual_seed(heads)
    n = adj.shape[0]
    s_src, s_dst = (3 * torch.randn((n, heads), device=cuda, generator=g) for _ in range(2))
    d_alpha = torch.randn((adj.nnz, heads), device=cuda, generator=g)
    return maps, s_src, s_dst, d_alpha


@pytest.mark.parametrize("heads", [1, 3, 4])
def test_edge_softmax_kernels_match_their_plain_versions(cuda, heads):
    """GAT's edge softmax, its backward by rows, its column sums and the
    rewrite of α into A's and Aᵀ's tile copies on the card against the plain
    versions in float64 (the kernels add each row in another order; the
    rewrite copies, bit for bit), twice with the same bits (no atomics),
    with their launches counted."""
    from repro_torch.kernels.hbp_spmv import (
        hbp_edge_softmax,
        hbp_edge_softmax_backward,
        hbp_edge_softmax_columns,
        hbp_rewrite,
    )

    maps, s_src, s_dst, d_alpha = _softmax_case(cuda, heads)
    wrappers = (hbp_edge_softmax, hbp_edge_softmax_backward, hbp_edge_softmax_columns,
                hbp_rewrite)

    def kernels():
        alpha = hbp_edge_softmax(maps.indptr, maps.cols, maps.walk, s_src, s_dst)
        de, d_dst = hbp_edge_softmax_backward(maps.indptr, maps.cols, maps.walk, s_src, s_dst,
                                              alpha, d_alpha)
        d_src = hbp_edge_softmax_columns(maps.indptr_T, maps.perm_T, maps.walk_T, de)
        return (alpha, de, d_dst, d_src, hbp_rewrite(maps.entry, alpha),
                hbp_rewrite(maps.entry_T, alpha))

    before = [w.launches for w in wrappers]
    got = kernels()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1, 2]
    f64 = [t.double() for t in (s_src, s_dst, got[0], d_alpha)]
    alpha = ref.edge_softmax(maps.indptr, maps.cols, *f64[:2])
    de, d_dst = ref.edge_softmax_backward(maps.indptr, maps.cols, *f64)
    d_src = ref.edge_softmax_columns(maps.indptr_T, maps.perm_T, de)
    for a, b in zip(got, (alpha, de, d_dst, d_src)):
        _close(a.double(), b)
    for a, entry in zip(got[4:], (maps.entry, maps.entry_T)):  # α copied as it is
        assert torch.equal(a, ref.rewritten_values(entry, got[0]))
        assert int((a != 0).sum()) == int((got[0] != 0).sum())
    assert all(torch.equal(a, b) for a, b in zip(got, kernels()))  # one order every launch
    wide = torch.zeros((s_src.shape[0], 9), device=cuda)  # the kernels' instances: 1-8 heads
    with pytest.raises(ValueError, match="heads"):
        hbp_edge_softmax(maps.indptr, maps.cols, maps.walk, wide, wide)


def test_gat_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Three GAT steps through the registry-served pair: the fused sum
    kernel on the rewritten tiles, the SDDMM and the edge softmax's kernels
    on the card, the plain versions on the CPU, from the same weights; rtol
    1e-4 as test_training_on_the_card_matches_the_cpu (kernel 2's fused
    multiply-adds, the sums' other orders on the card)."""
    from repro_torch.graph import power_law_graph
    from repro_torch.graph.train import NodeClassifierTrainer
    from repro_torch.kernels.hbp_spmv import (
        hbp_edge_softmax,
        hbp_edge_softmax_backward,
        hbp_edge_softmax_columns,
        hbp_rewrite,
        hbp_sddmm,
    )
    from repro_torch.serving import MatrixRegistry

    adj = power_law_graph(3000, 8.0, seed=6, symmetric=True)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    labels = rng.integers(0, 5, 3000)
    params = NodeClassifierTrainer([32, 48, 5], model="gat", heads=3, device="cpu").init(4)
    arrays = [[t.numpy() for t in p] for p in params.params]
    hist = {}
    for dev in (cuda, "cpu"):
        reg = MatrixRegistry(device=dev, cache_dir=tmp_path / str(dev), search=False)
        trainer = NodeClassifierTrainer([32, 48, 5], model="gat", heads=3, registry=reg)
        agg = trainer.aggregator(trainer.prepare_adjacency(adj))
        state = trainer.load_state(arrays)
        softmax = (hbp_edge_softmax, hbp_edge_softmax_backward, hbp_edge_softmax_columns,
                   hbp_rewrite)
        before = (hbp_sddmm.launches, hbp_spmm_fused.launches, [w.launches for w in softmax])
        readings = []
        for _ in range(3):
            state, out = trainer.step(state, agg, x, labels)
            readings.append((out["loss"], out["grad_norm"]))
        if dev is cuda:  # 2 layers: one SDDMM, 3 + 3 head products, the
            # softmax's forward, rows and columns and two rewrites each, a step
            assert hbp_sddmm.launches - before[0] == 3 * 2
            assert hbp_spmm_fused.launches - before[1] == 3 * 2 * 6
            assert [w.launches - b for w, b in zip(softmax, before[2])] == [6, 6, 6, 12]
        hist[str(dev)] = np.array(readings)
    # AdamW's first steps move a weight by ~lr whatever its gradient's size,
    # so the losses and gradient norms are compared, not the weights
    np.testing.assert_allclose(hist[str(cuda)], hist["cpu"], rtol=1e-4)


# --- the solvers on the card --------------------------------------------------


def _solver_problems():
    """Small well-conditioned systems and a PageRank matrix: ``(spd tiles,
    spd csr, nonsymmetric tiles, transition tiles, dangling, nonsymmetric
    csr)``."""
    from repro_torch.solvers import transition_matrix

    A = circuit(600, seed=1).to_dense()
    spd = csr_from_dense((A @ A.T / 600 + np.eye(600)).astype(np.float32))
    nonsym = csr_from_dense((A + (np.abs(A).sum(1).max() + 1) * np.eye(600)).astype(np.float32))
    M, dang = transition_matrix(rmat(1 << 10, 9000, seed=9, symmetric=False))
    cfg = PartitionConfig(row_block=64, col_block=256, group=8, lane=8)
    return (build_tiles(spd, cfg), spd, build_tiles(nonsym, cfg), build_tiles(M, cfg), dang,
            nonsym)


def _solver_runs(dev, strategy):
    """name -> (run, operator launches before the loop, per step, k)."""
    from repro_torch import solvers as S

    spd_t, spd, nonsym_t, M_t, dang, nonsym = _solver_problems()
    op = S.aslinearoperator(spd_t, strategy=strategy, device=dev)
    nop = S.aslinearoperator(nonsym_t, strategy=strategy, device=dev)
    mop = S.aslinearoperator(M_t, strategy=strategy, device=dev)
    rng = np.random.default_rng(15)
    b = torch.as_tensor(rng.standard_normal(600).astype(np.float32), device=dev)
    B = torch.as_tensor(rng.standard_normal((600, 4)).astype(np.float32), device=dev)
    P = torch.as_tensor(rng.random((M_t.shape[0], 3)).astype(np.float32) + 0.01, device=dev)
    jac = S.jacobi(spd, device=dev)
    bj = S.block_jacobi(spd, blocks=S.hash_group_blocks(spd_t), device=dev)
    return {
        "cg": (lambda: S.cg(op, b, tol=1e-6), 1, 1, 1),
        "cg-block": (lambda: S.cg(op, B, tol=1e-6), 1, 1, 4),
        "pcg-jacobi": (lambda: S.cg(op, B, tol=1e-6, M=jac), 1, 1, 4),
        "pcg-block-jacobi": (lambda: S.cg(op, b, tol=1e-6, M=bj), 1, 1, 1),
        "bicgstab": (lambda: S.bicgstab(nop, b, tol=1e-6, M=S.jacobi(nonsym, device=dev)),
                     1, 2, 1),
        "bicgstab-block": (lambda: S.bicgstab(nop, B, tol=1e-6), 1, 2, 4),
        "chebyshev": (lambda: S.chebyshev(op, b, lam_min=1.0, lam_max=40.0, tol=0.0,
                                          maxiter=21), 1, 1, 1),
        "power": (lambda: S.power_iteration(op, tol=1e-5, maxiter=500), 1, 2, 1),
        "pagerank": (lambda: S.pagerank(mop, dangling=dang), 0, 1, 1),
        "pagerank-block": (lambda: S.pagerank(mop, dangling=dang, personalization=P), 0, 1, 3),
    }


@pytest.mark.parametrize("strategy", ["fused", "partials"])
def test_solver_chunks_make_no_host_sync(cuda, monkeypatch, strategy):
    """Every chunk of every solver runs under set_sync_debug_mode("error"):
    the only host reads of a solve are the flag between chunks (and the
    history's one read after the loop).  Each solve agrees with the same
    solve on the CPU (the kernels' plain versions)."""
    from repro_torch.solvers import base

    orig = base._chunk
    chunks = []

    def guarded(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        chunks.append(args[5])
        return out

    cpu_runs = _solver_runs("cpu", strategy)
    card_runs = _solver_runs(cuda, strategy)
    for name, (run, *_) in card_runs.items():
        run()  # warm-up: kernel build and load outside the guard
        monkeypatch.setattr(base, "_chunk", guarded)
        chunks.clear()
        res = run()
        monkeypatch.setattr(base, "_chunk", orig)
        assert chunks, name
        want = cpu_runs[name][0]()
        assert int(res.iterations) == int(want.iterations), name
        got, ref_x = res[0].cpu(), want[0]  # x, or the eigenvalue
        _close(got, ref_x)


@pytest.mark.parametrize("strategy,k", [("fused", 1), ("fused", 4), ("partials", 1),
                                        ("partials", 4)])
def test_solver_launch_counts_match_the_loop(cuda, strategy, k):
    """During a solve a kernel's counter rises by exactly the launches the
    solver loop issues: the operator applications before the loop, plus
    those of every step it launched (the live steps and the masked tail of
    the last chunk)."""
    from repro_torch.solvers import base

    kernel = {("fused", 1): hbp_spmv_fused, ("fused", 4): hbp_spmm_fused,
              ("partials", 1): hbp_spmv_partials, ("partials", 4): hbp_spmm_partials}
    runs = _solver_runs(cuda, strategy)
    seen = 0
    for name, (run, setup, per_step, width) in runs.items():
        if (width == 1) != (k == 1):
            continue
        run()
        counter = kernel[strategy, k]
        before = counter.launches
        res = run()
        it = int(res.iterations)
        maxiter = res.history.shape[0] - 1
        steps = min(-(-it // base.CHECK_EVERY) * base.CHECK_EVERY, maxiter)
        assert counter.launches - before == setup + per_step * steps, (name, it)
        seen += 1
    assert seen >= 4


@pytest.mark.parametrize("strategy", ["fused", "partials"])
def test_plan_operator_is_the_tiles_operator_on_the_card(cuda, tmp_path, strategy):
    """plan.operator() gives the bits of aslinearoperator over the plan's
    tiles under the plan's strategy, and so does a preconditioned solve."""
    from repro_torch.serving import MatrixRegistry
    from repro_torch.solvers import aslinearoperator, cg, jacobi

    spd_t, spd, *_ = _solver_problems()
    reg = MatrixRegistry(device=cuda, cache_dir=tmp_path, search=False, strategy=strategy)
    plan = reg.admit(spd, "spd")
    op = aslinearoperator(plan.tiles, strategy=strategy, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(16)
    for shape in ((600,), (600, 3), (600, 8)):
        x = torch.randn(*shape, device=cuda, generator=g)
        assert torch.equal(plan.operator()(x), op(x)), shape
    b = torch.randn(600, device=cuda, generator=g)
    a = cg(plan.operator(), b, M=plan.jacobi())
    c = cg(op, b, M=jacobi(plan.diag, device=cuda))
    assert bool(a.converged) and int(a.iterations) == int(c.iterations)
    assert torch.equal(a.x, c.x) and torch.equal(a.history.nan_to_num(), c.history.nan_to_num())


# --- telemetry against the card, and the distributed SpMV --------------------


@pytest.mark.parametrize("strategy", ["fused", "partials"])
def test_attribution_against_the_cards_spec(cuda, tmp_path, strategy):
    """The attribution rows of served traffic take the card's spec by
    default, count one launch per flush (the rise of the strategy's two
    kernel counters) and stay under the card's peak rate."""
    from repro_torch.analysis.roofline import spec_for
    from repro_torch.obs.attribution import attribution_rows, render_attribution
    from repro_torch.obs.planview import explain_report
    from repro_torch.serving import MatrixRegistry, ServingEngine

    kernels = {"fused": (hbp_spmv_fused, hbp_spmm_fused),
               "partials": (hbp_spmv_partials, hbp_spmm_partials)}[strategy]
    reg = MatrixRegistry(cache_dir=tmp_path, search=False, strategy=strategy)
    A = circuit(20000, seed=4)
    reg.admit(A, "a")
    before = sum(k.launches for k in kernels)
    eng = ServingEngine(reg, max_batch=16, max_wait_s=0.0)
    rng = np.random.default_rng(2)
    for burst in (1, 16, 3, 8, 1, 5):
        tickets = [eng.submit("a", rng.standard_normal(A.shape[1]).astype(np.float32))
                   for _ in range(burst)]
        eng.poll()
    eng.flush()
    for t in tickets:
        assert t.result().shape == (A.shape[0],)
    launched = sum(k.launches for k in kernels) - before
    snapshot = {"registries": [reg.metrics.collect()]}
    spec = spec_for(torch.cuda.get_device_name(cuda))
    (row,) = attribution_rows(snapshot)
    assert row == attribution_rows(snapshot, hw=spec)[0]
    assert row["strategy"] == strategy and row["launches"] == launched > 0
    assert 0 < row["roofline_fraction"] <= 1.05, row
    assert f"vs {spec.name}" in render_attribution([row])
    assert f"of {spec.name} HBM" in explain_report(snapshot, "a")


@pytest.mark.parametrize("mode", ["balanced", "grid"])
def test_sharded_matvec_world_1_nccl_against_the_plain_version(cuda, tmp_path, mode):
    import torch.distributed as dist

    from repro_torch.core.distributed import build_sharded_spmv

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        A = circuit(6000, seed=5)
        sh = build_sharded_spmv(A, cfg=PartitionConfig(row_block=256, col_block=1024),
                                mode=mode)
        assert sh.device.type == "cuda" and sh.loads.tolist() == [sh.tiles.n_tiles]
        x = torch.randn(A.shape[1], device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(3))
        before = hbp_spmv_partials.launches
        y = sh.matvec(x)
        assert hbp_spmv_partials.launches == before + 1
        assert torch.equal(sh.matvec(x), y)
        d = sh.local
        nrg = sh.tiles.n_rowgroups
        want = ref.unpermute(ref.segment_sum_sorted(
            hbp_spmv_partials_plain(d, x), d.rowgroup, nrg + 1, d.rg_lengths)[:nrg],
            d.perm, A.shape[0])
        _close(y, want)
        y64 = A.matvec(x.cpu().numpy().astype(np.float64))
        assert np.abs(y.cpu().numpy() - y64).max() <= 1e-4 * np.abs(y64).max()
    finally:
        dist.destroy_process_group()


# --- the LM serving path on the card ----------------------------------------


def test_sparse_linear_on_the_card_matches_its_plain_version(cuda):
    from repro_torch.core.sparse_linear import SparseLinear, magnitude_prune

    w = np.random.default_rng(15).standard_normal((1024, 700)).astype(np.float32)
    layer = SparseLinear.from_dense(w, sparsity=0.9, device=cuda)
    plain = SparseLinear.from_dense(w, sparsity=0.9, backend="torch", device=cuda)
    host = SparseLinear.from_dense(w, sparsity=0.9, device="cpu")  # the kernels' plain versions
    pruned = torch.as_tensor(magnitude_prune(w, 0.9), dtype=torch.float64, device=cuda)
    hbp_spmv_fused.launches = hbp_spmm_fused.launches = 0
    for k in (1, 4):
        x = torch.randn(k, 700, device=cuda, generator=torch.Generator(device=cuda).manual_seed(k))
        y = layer.apply(x)
        bound = 1e-5 * (x.double().abs() @ pruned.abs().T) + 1e-30
        for other in (x.double() @ pruned.T, plain.apply(x).double(),
                      host.apply(x.cpu()).to(cuda).double()):
            assert bool(torch.all((y.double() - other).abs() <= bound))
        for i in range(k):
            assert torch.equal(layer.apply(x[i]), y[i])
    # k = 1: the layer's SpMV and the one per-token check; k = 4: one SpMM
    # and four per-token SpMVs (the plain layers launch nothing)
    assert hbp_spmv_fused.launches == 2 + 4 and hbp_spmm_fused.launches == 1


def test_engine_on_the_card_gives_the_cpu_tokens(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, tree_map
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=2, vocab=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.random.default_rng(i).integers(0, 128, 6).astype(np.int32) for i in range(2)]
    outs = {}
    for dev in ("cpu", cuda):
        reqs = [Request(prompt=p.copy(), max_new=8) for p in prompts]
        Engine(model, params, EngineConfig(batch=2, max_len=64), device=dev).generate(reqs)
        outs[str(dev)] = np.stack([r.out for r in reqs])
    # teacher-forced on the CPU's tokens: the logits agree, and the tokens
    # wherever the CPU's top-2 gap leaves no near tie
    fed = outs["cpu"]
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64)
    logits = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        cache = model.init_cache(2, 64, device=dev)
        cache, last = make_prefill_step(model)(p, {"tokens": toks.to(dev)}, cache)
        steps = [last.cpu()]
        for s in range(7):
            cur = torch.as_tensor(fed[:, s : s + 1], dtype=torch.int64, device=dev)
            cache, _, last = make_decode_step(model)(p, cache, cur, 6 + s)
            steps.append(last.cpu())
        logits[str(dev)] = torch.stack(steps, 1)  # [2, 8, padded vocab]
    # the padded columns hold -1e30 in both; the 128 real ones agree
    assert bool(torch.all(logits["cuda"][..., 128:] == -1e30))
    want, got = logits["cpu"][..., :128], logits["cuda"][..., :128]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-3).numpy()
    assert clear.mean() > 0.5
    for i in range(2):
        n = 8 if clear[i].all() else int(np.argmin(clear[i]))
        assert np.array_equal(outs["cuda"][i, :n], fed[i, :n])


# --- LM training on the card --------------------------------------------------


def _train_batch(cfg, seed=1, b=4, s=16):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), dtype=torch.int64)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)), dtype=torch.float32)
    if cfg.is_encdec:
        batch["frames"] = torch.as_tensor(rng.standard_normal((b, s, cfg.d_model)),
                                          dtype=torch.float32)
    return batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One step (two microbatches, remat) of every architecture's smoke
    config on the card and on the CPU from the same weights: loss within
    ``rtol=1e-5``, grad norm within ``rtol=1e-4``; parameters within
    ``rtol=1e-5, atol=1e-5 * max|leaf| + 1e-2 * lr`` where the CPU's first
    moment is at least 1e-4 of its leaf's largest, and everywhere within
    ``2 * lr`` (the step of an unresolved gradient's sign)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, tree_map
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.train import make_train_step

    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=50)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _train_batch(cfg)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        state = {"params": p, "opt": init_opt_state(p, ocfg)}
        step = make_train_step(model, ocfg, n_microbatch=2, remat=True)
        out.append(step(state, {k: v.to(dev) for k, v in batch.items()}))
    torch.backends.cuda.matmul.allow_tf32 = prev
    (s_cpu, m_cpu), (s_dev, m_dev) = out
    np.testing.assert_allclose(float(m_dev["loss"]), float(m_cpu["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_dev["grad_norm"]), float(m_cpu["grad_norm"]), rtol=1e-4)
    lr = float(m_cpu["lr"])
    for a, b, m in zip(tree_leaves(s_dev["params"]), tree_leaves(s_cpu["params"]),
                       tree_leaves(s_cpu["opt"]["m"])):
        err = (a.cpu() - b).abs()
        tight = err <= 1e-5 * b.abs() + 1e-5 * b.abs().max() + 1e-2 * lr
        resolved = m.abs() >= 1e-4 * m.abs().max()
        assert bool(torch.all(tight[resolved])) and err.max().item() <= 2 * lr


def test_decode_on_the_card_is_unchanged_by_the_stack_unbind(cuda, monkeypatch):
    """The stack is unbound once per call; indexing it group by group, as
    before, gives the same tokens and the same logits bit for bit."""
    import dataclasses

    import repro_torch.models.transformer as transformer
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, tree_map
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=4, vocab=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    prompts = [np.random.default_rng(i).integers(0, 128, 6).astype(np.int32) for i in range(2)]

    def serve():
        reqs = [Request(prompt=p.copy(), max_new=8) for p in prompts]
        Engine(model, params, EngineConfig(batch=2, max_len=64), device=cuda).generate(reqs)
        full, _, _ = model.forward(params, {"tokens": torch.as_tensor(
            np.stack([np.concatenate([p, r.out]) for p, r in zip(prompts, reqs)]),
            dtype=torch.int64, device=cuda)})
        return np.stack([r.out for r in reqs]), full

    tokens, logits = serve()
    monkeypatch.setattr(transformer, "_unbind", lambda stacked, n: [
        tree_map(lambda a: a[g], stacked) for g in range(n)])
    tokens_indexed, logits_indexed = serve()
    assert np.array_equal(tokens, tokens_indexed) and torch.equal(logits, logits_indexed)
