"""Host-side admission of the PyTorch port against the JAX package.

The port keeps its own copy of the numpy admission pipeline (2D
partition, nonlinear hash, tile packing); these tests hold its arrays
equal — not close — to ``repro.core``'s on the same matrices, and check
that ``tiles_from_arrays`` carries the JAX package's tile state into the
port unchanged.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.matrices as jmat
import repro.serving.autotune as jtune
import repro_torch.core as tcore
import repro_torch.core.matrices as tmat
import repro_torch.serving.autotune as ttune
from repro_torch.kernels import ops

TILE_FIELDS = ("data", "cols", "rowgroup", "colblock", "first", "perm")

# small instances of every generator family of the suite
GENERATORS = {
    "circuit": lambda m: m.circuit(300, seed=1, n_dense_rows=2, dense_row_frac=0.05),
    "rmat": lambda m: m.rmat(1 << 9, 3000, seed=2),
    "banded_fem": lambda m: m.banded_fem(400, seed=3, band=6, fill=0.8),
    "dense_block": lambda m: m.dense_block(600, seed=4, block=64, n_blocks=3),
    "uniform_random": lambda m: m.uniform_random(300, 0.02, seed=5),
}

SMALL = dict(row_block=64, col_block=128, group=8, lane=16)


def _configs(kind, csr_j, csr_t):
    if kind == "default":
        return jcore.PartitionConfig(), tcore.PartitionConfig()
    if kind == "small":
        return jcore.PartitionConfig(**SMALL), tcore.PartitionConfig(**SMALL)
    return jcore.tuned_partition_config(csr_j), tcore.tuned_partition_config(csr_t)


def _assert_tiles_equal(tj, tt):
    for f in TILE_FIELDS:
        a, b = getattr(tj, f), getattr(tt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tuple(tj.shape) == tuple(tt.shape)
    assert tj.n_rowgroups == tt.n_rowgroups
    assert dataclasses.asdict(tj.cfg) == dataclasses.asdict(tt.cfg)


@pytest.mark.parametrize("cfg_kind", ["default", "tuned", "small"])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_build_tiles_equal_to_jax(gen, cfg_kind):
    csr_j = GENERATORS[gen](jmat)
    csr_t = GENERATORS[gen](tmat)
    np.testing.assert_array_equal(csr_j.indptr, csr_t.indptr)
    np.testing.assert_array_equal(csr_j.indices, csr_t.indices)
    np.testing.assert_array_equal(csr_j.data, csr_t.data)
    cj, ct = _configs(cfg_kind, csr_j, csr_t)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    _assert_tiles_equal(jcore.build_tiles(csr_j, cj), tcore.build_tiles(csr_t, ct))


def test_build_tiles_empty_matrix_equal_to_jax():
    dense = np.zeros((20, 30), np.float32)
    tj = jcore.build_tiles(jcore.csr_from_dense(dense), jcore.PartitionConfig(**SMALL))
    tt = tcore.build_tiles(tcore.csr_from_dense(dense), tcore.PartitionConfig(**SMALL))
    assert tt.n_tiles == 0
    _assert_tiles_equal(tj, tt)
    dt = ops.device_tiles(tt, "cpu")
    y = ops.hbp_spmv(dt, np.ones(30, np.float32))
    assert torch.equal(y, torch.zeros(20))


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_matrix_hash_identical(gen):
    assert jtune.matrix_hash(GENERATORS[gen](jmat)) == ttune.matrix_hash(
        GENERATORS[gen](tmat)
    )


def test_tiles_from_arrays_round_trips_jax_tiles():
    csr = GENERATORS["circuit"](jmat)
    tj = jcore.build_tiles(csr, jcore.tuned_partition_config(csr))
    d = {f: getattr(tj, f) for f in TILE_FIELDS}
    d.update(shape=tj.shape, n_rowgroups=tj.n_rowgroups, cfg=dataclasses.asdict(tj.cfg))
    tt = tcore.tiles_from_arrays(d)
    _assert_tiles_equal(tj, tt)
    # a config object works as well as a mapping, and so do top-level keys
    _assert_tiles_equal(tj, tcore.tiles_from_arrays({**d, "cfg": tj.cfg}))
    flat = {k: v for k, v in d.items() if k != "cfg"}
    _assert_tiles_equal(tj, tcore.tiles_from_arrays({**flat, **dataclasses.asdict(tj.cfg)}))
    # the round-tripped tiles stage and multiply like the port's own build
    x = np.random.default_rng(0).standard_normal(csr.shape[1]).astype(np.float32)
    y = ops.hbp_spmv(ops.device_tiles(tt, "cpu"), x, strategy="stable").numpy()
    np.testing.assert_allclose(y, csr.to_dense() @ x, rtol=1e-5, atol=1e-5)


def test_tiles_from_arrays_rejects_mismatched_geometry():
    csr = GENERATORS["banded_fem"](tmat)
    tt = tcore.build_tiles(csr, tcore.PartitionConfig(**SMALL))
    d = {f: getattr(tt, f) for f in TILE_FIELDS}
    d.update(shape=tt.shape, n_rowgroups=tt.n_rowgroups, cfg={**SMALL, "lane": 32})
    with pytest.raises(ValueError, match="tile shape"):
        tcore.tiles_from_arrays(d)


def test_device_tiles_run_index():
    csr = GENERATORS["rmat"](tmat)
    tt = tcore.build_tiles(csr, tcore.PartitionConfig(**SMALL))
    dt = ops.device_tiles(tt, "cpu")
    starts = dt.run_start.numpy()
    assert starts[0] == 0 and starts[-1] == tt.n_tiles
    np.testing.assert_array_equal(starts[:-1], np.flatnonzero(tt.first))
    np.testing.assert_array_equal(dt.run_rowgroup.numpy(), np.unique(tt.rowgroup))
    assert int(dt.rg_lengths.sum()) == tt.n_tiles
    assert dt.nbytes == sum(t.nbytes for t in dt.tensors())


def test_device_tiles_rejects_unsorted_runs():
    csr = GENERATORS["circuit"](tmat)
    tt = tcore.build_tiles(csr, tcore.PartitionConfig(**SMALL))
    assert len(np.unique(tt.rowgroup)) > 1
    bad = dataclasses.replace(
        tt,
        data=tt.data[::-1].copy(), cols=tt.cols[::-1].copy(),
        rowgroup=tt.rowgroup[::-1].copy(), colblock=tt.colblock[::-1].copy(),
        first=np.r_[1, (tt.rowgroup[::-1][1:] != tt.rowgroup[::-1][:-1])].astype(np.int32),
    )
    with pytest.raises(ValueError, match="strictly increasing"):
        ops.device_tiles(bad, "cpu")
