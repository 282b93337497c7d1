"""The port's distributed SpMV on ``torch.distributed`` against the JAX package.

Each case runs ``world`` = 1, 2 or 4 ranks as separate processes under
gloo on the CPU, joined through a fresh ``file://`` rendezvous (no TCP
port, so parallel test workers cannot collide), each process and the
whole case bounded by its own timeout.  Every rank builds
``circuit(4000, seed=2)`` under both placements and multiplies one x
twice.  The checks:

* y within 1e-4 (relative to ``|y|_inf``) of ``CSRMatrix.matvec`` — the
  JAX package's ``ShardedSpmv.matvec`` cannot be the reference: it fails
  under the installed JAX (``core/distributed.py:99``);
* the two calls, and every rank's y, bitwise equal;
* each rank's tile ids padded to ``t_max`` give exactly the JAX package's
  shard of that rank (data, cols, row groups, column blocks, the -1 null
  tiles), and ``loads`` equal its loads — its ``build_sharded_spmv`` runs
  on a CPU mesh of ``world`` devices in a subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count``); only its
  ``matvec`` fails;
* on the R-MAT of ``test_balanced_beats_grid_makespan`` the balanced
  placement's makespan (max/mean load over 8 ranks) is at most the grid's,
  and both placements' loads equal the JAX package's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.matrices as jmat
import repro_torch.core as tcore
import repro_torch.core.matrices as tmat
from repro_torch.core import distributed as tdist

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(row_block=128, col_block=512)
RMAT_WORLD = 8
TIMEOUT_S = 240  # per process; a hung rank fails its case, not the suite

WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
from repro_torch.core import PartitionConfig
from repro_torch.core.distributed import build_sharded_spmv, shard_tiles
from repro_torch.core.matrices import circuit

A = circuit(4000, seed=2)
x = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
res = {}
sh = build_sharded_spmv(A, cfg=PartitionConfig(row_block=128, col_block=512),
                        mode="balanced", device="cpu")
for mode in ("balanced", "grid"):
    if mode == "grid":
        sh = shard_tiles(sh.tiles, mode="grid", device="cpu")
    assert (sh.rank, sh.world, sh.mode) == (rank, world, mode)
    res[mode + "_y1"] = sh.matvec(x).numpy()
    res[mode + "_y2"] = sh.matvec(x).numpy()
    res[mode + "_ids"] = sh.ids
    res[mode + "_loads"] = sh.loads
    res[mode + "_t_max"] = np.int64(sh.t_max)
dist.destroy_process_group()
np.savez(out, **res)
"""

REFERENCE = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import PartitionConfig
from repro.core.distributed import build_sharded_spmv
from repro.core.matrices import circuit, rmat

res = {}
cases = [(w, "circuit", circuit(4000, seed=2)) for w in (1, 2, 4)]
cases.append((int(sys.argv[2]), "rmat", rmat(1 << 12, 120_000, seed=1)))
for w, label, A in cases:
    mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
    for mode in ("balanced", "grid"):
        sh = build_sharded_spmv(A, mesh, cfg=PartitionConfig(row_block=128, col_block=512),
                                mode=mode)
        tag = f"{label}_{w}_{mode}"
        res[tag + "_loads"] = sh.loads
        if label == "circuit":
            for f in ("data", "cols", "rowgroup", "colblock"):
                res[f"{tag}_{f}"] = np.asarray(getattr(sh, f))
np.savez(sys.argv[1], **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_shards") / "ref.npz"
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out), str(RMAT_WORLD)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={RMAT_WORLD}",
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=TIMEOUT_S,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


def _run_ranks(world, tmp_path):
    """Run the worker on ``world`` gloo ranks; every rank's results."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), init,
             str(tmp_path / f"rank{r}.npz")],
            env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + "\n".join(logs)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_spmv_matches_csr_and_the_jax_placement(world, tmp_path, reference):
    A = tmat.circuit(4000, seed=2)
    x = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    y_ref = jmat.circuit(4000, seed=2).matvec(x)
    tiles = tcore.build_tiles(A, tcore.PartitionConfig(**CFG), method="hash")
    ranks = _run_ranks(world, tmp_path)
    for mode in tdist.MODES:
        tag = f"circuit_{world}_{mode}"
        y = ranks[0][mode + "_y1"]
        err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
        assert err < 1e-4, (mode, err)
        ids_all, loads = tdist.place_tiles(tiles, world, mode)
        np.testing.assert_array_equal(loads, reference[tag + "_loads"])
        for r, res in enumerate(ranks):
            assert np.array_equal(res[mode + "_y1"], res[mode + "_y2"]), (mode, r)
            assert np.array_equal(res[mode + "_y1"], y), (mode, r)
            np.testing.assert_array_equal(res[mode + "_ids"], ids_all[r])
            np.testing.assert_array_equal(res[mode + "_loads"], loads)
            t_max = int(res[mode + "_t_max"])
            assert t_max == reference[tag + "_rowgroup"].shape[1]
            shard = tdist.pad_shard(tiles, res[mode + "_ids"], t_max)
            for f, got in zip(("data", "cols", "rowgroup", "colblock"), shard):
                np.testing.assert_array_equal(got, reference[f"{tag}_{f}"][r],
                                              err_msg=f"{mode} rank {r} {f}")


def test_balanced_beats_grid_makespan(reference):
    A = tmat.rmat(1 << 12, 120_000, seed=1)
    tiles = tcore.build_tiles(A, tcore.PartitionConfig(**CFG), method="hash")
    ratio = {}
    for mode in tdist.MODES:
        ids, loads = tdist.place_tiles(tiles, RMAT_WORLD, mode)
        np.testing.assert_array_equal(loads, reference[f"rmat_{RMAT_WORLD}_{mode}_loads"])
        assert sorted(np.concatenate(ids).tolist()) == list(range(tiles.n_tiles))
        ratio[mode] = loads.max() / loads.mean()
    assert ratio["balanced"] <= ratio["grid"] + 1e-9, ratio


def test_placement_rejects_unknown_modes_and_pads_null_tiles():
    A = tmat.circuit(300, seed=1)
    tiles = tcore.build_tiles(A, tcore.PartitionConfig(row_block=64, col_block=128),
                              method="hash")
    with pytest.raises(ValueError, match="placement"):
        tdist.place_tiles(tiles, 2, "random")
    ids = np.arange(3)
    data, cols, rowgroup, colblock = tdist.pad_shard(tiles, ids, 5)
    assert data.shape[0] == cols.shape[0] == 5
    assert rowgroup[3:].tolist() == [-1, -1] and not data[3:].any() and not cols[3:].any()
    np.testing.assert_array_equal(colblock[:3], tiles.colblock[:3])
