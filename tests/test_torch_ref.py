"""The port's ``"stable"`` and ``"reference"`` SpMM against the JAX package's.

Same tiles (the JAX build, carried over with ``tiles_from_arrays``), same
seeded x; the JAX side runs its jnp paths, the port its plain PyTorch
references on the CPU.  Tolerance: ``rtol=1e-5,
atol=1e-5 * max(1, |y_jax|_inf)`` — the lane sums are taken in different
orders.

The JAX ``"stable"`` chain unrolls every lane into its trace, so at lane
128 each new width costs seconds of compilation; that lane runs a reduced
set of widths (one below and one above a 128-wide chunk, under both
contracts) to keep the file fast.  The fused path covers the full cross product in
``test_torch_kernels.py``.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest

import repro.core as jcore
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch.kernels import ops as tops

KS = (1, 3, 8, 128, 129, 256)
FIELDS = ("data", "cols", "rowgroup", "colblock", "first", "perm")

CASES = [
    (s, 8, k, kt) for s in ("stable", "reference") for k in KS for kt in ("grid", "loop")
] + [
    (s, 128, k, kt)
    for s in ("stable", "reference")
    for k, kt in ((3, "grid"), (129, "grid"), (129, "loop"))
]

_TILES = {}


def _tiles(lane):
    """(JAX tiles, the same tiles staged by the port on the CPU), cached."""
    if lane not in _TILES:
        rng = np.random.default_rng(lane)
        dense = rng.standard_normal((60, 80)) * (rng.random((60, 80)) < 0.15)
        cfg = jcore.PartitionConfig(row_block=32, col_block=32, group=8, lane=lane)
        tj = jcore.build_tiles(jcore.csr_from_dense(dense.astype(np.float32)), cfg)
        d = {f: getattr(tj, f) for f in FIELDS}
        d.update(shape=tj.shape, n_rowgroups=tj.n_rowgroups, cfg=dataclasses.asdict(cfg))
        _TILES[lane] = tj, tops.device_tiles(tcore.tiles_from_arrays(d), "cpu")
    return _TILES[lane]


@pytest.mark.parametrize("strategy,lane,k,k_tiling", CASES)
def test_spmm_matches_jax(strategy, lane, k, k_tiling):
    tj, dt = _tiles(lane)
    X = np.random.default_rng(k).standard_normal((tj.shape[1], k)).astype(np.float32)
    y_j = np.asarray(jops.hbp_spmm(tj, X, strategy=strategy, k_tiling=k_tiling))
    y_t = tops.hbp_spmm(dt, X, strategy=strategy, k_tiling=k_tiling).numpy()
    atol = 1e-5 * max(1.0, float(np.abs(y_j).max()))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=atol)
