"""The port's CUDA kernels on the card (``-m gpu``; they skip without one).

Whether a card is present is decided inside the ``cuda`` fixture, never
at import or collection time, so every test process collects the same
tests.  Each kernel is held against its plain PyTorch version on the same
inputs with ``rtol=1e-5, atol=1e-5 * max(1, |y_plain|_inf)`` (the kernel
fuses each multiply-add and keeps one chain per run), and the bitwise
invariants the serving engine relies on are checked on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import PartitionConfig, build_tiles
from repro_torch.core.matrices import banded_fem, circuit, rmat
from repro_torch.kernels import ops
from repro_torch.kernels.hbp_spmv import (
    hbp_spmm_fused,
    hbp_spmm_fused_plain,
    hbp_spmv_fused,
    hbp_spmv_fused_plain,
)

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


def test_launch_counters_count_launches_only(cuda):
    dt = _staged(cuda, "circuit", 8)
    x = torch.ones(dt.shape[1], device=cuda)
    v0, m0 = hbp_spmv_fused.launches, hbp_spmm_fused.launches
    hbp_spmv_fused(dt, x)
    hbp_spmm_fused(dt, x[:, None].repeat(1, 4))
    hbp_spmv_fused_plain(dt, x)
    assert (hbp_spmv_fused.launches, hbp_spmm_fused.launches) == (v0 + 1, m0 + 1)


@pytest.mark.parametrize("strategy", ["fused", "stable"])
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


def test_served_answers_equal_matvec_on_the_card(cuda, tmp_path):
    from repro_torch.serving import MatrixRegistry, ServingEngine

    reg = MatrixRegistry(cache_dir=tmp_path, search=False)
    assert reg.strategy == "fused" and reg.device.type == "cuda"
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
