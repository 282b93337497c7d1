"""Synthetic sparse-matrix generators modelled on the paper's test suite.

The paper evaluates on 14 matrices from the University of Florida (SuiteSparse)
collection (Table I).  The collection is not available offline, so this module
provides generators that reproduce the *structural* characteristics of each
matrix family used in the paper:

* ``kron_g500-lognNN``  — Kronecker/R-MAT power-law graphs (Graph500 spec),
  extreme row-imbalance, scattered column access.  (m4-m7)
* ``ASIC_*``, ``rajat*`` — circuit-simulation matrices: strong diagonal,
  a few dense rows/columns (power rails), mostly short rows.  (m1, m2, m11-m14)
* ``ohne2``, ``barrier2-3``, ``nxp1`` — semiconductor-device FEM matrices:
  banded with regular medium-length rows.  (m3, m9, m10)
* ``mip1`` — optimisation matrix: dense blocks and long rows.  (m8)

Every generator is deterministic given ``seed`` and returns a
:class:`repro.core.formats.CSRMatrix`.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .formats import COOMatrix, CSRMatrix, csr_from_coo

__all__ = [
    "rmat",
    "circuit",
    "banded_fem",
    "dense_block",
    "uniform_random",
    "paper_suite",
    "SUITE_SPECS",
]


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def rmat(
    n: int,
    nnz: int,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    symmetric: bool = True,
) -> CSRMatrix:
    """R-MAT / Kronecker power-law graph (Graph500 parameters by default).

    Mirrors the ``kron_g500-lognNN`` matrices: heavy-tailed row degree
    distribution, the worst case for per-warp load balance.
    """
    rng = _rng(seed)
    scale = int(np.ceil(np.log2(n)))
    n = 1 << scale
    m = nnz if not symmetric else max(1, nnz // 2)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_down = r >= a + b  # rows bit set
        go_right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        rows |= go_down.astype(np.int64) << level
        cols |= go_right.astype(np.int64) << level
    data = rng.standard_normal(m)
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        data = np.concatenate([data, data])
    return csr_from_coo(COOMatrix(rows, cols, data, (n, n)))


def circuit(
    n: int,
    *,
    seed: int = 0,
    avg_offdiag: float = 4.0,
    n_dense_rows: int = 8,
    dense_row_frac: float = 0.02,
) -> CSRMatrix:
    """Circuit-simulation matrix (ASIC_*/rajat* family).

    Full diagonal, geometric number of local off-diagonal entries per row and
    a handful of nearly-dense rows/columns (supply rails) that dominate the
    load-imbalance profile.
    """
    rng = _rng(seed)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    # local couplings: geometric count, near-diagonal columns
    cnt = rng.geometric(1.0 / (1.0 + avg_offdiag), size=n) - 1
    r = np.repeat(np.arange(n), cnt)
    spread = rng.integers(-2000, 2000, size=r.size)
    c = np.clip(r + spread, 0, n - 1)
    rows.append(r)
    cols.append(c)
    # dense rows and matching dense columns (rails)
    rail_len = max(1, int(n * dense_row_frac))
    for k in range(n_dense_rows):
        rail = rng.integers(0, n)
        touched = rng.choice(n, size=rail_len, replace=False)
        rows.append(np.full(rail_len, rail))
        cols.append(touched)
        rows.append(touched)
        cols.append(np.full(rail_len, rail))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = rng.standard_normal(rows.size)
    return csr_from_coo(COOMatrix(rows, cols, data, (n, n)))


def banded_fem(
    n: int,
    *,
    seed: int = 0,
    band: int = 24,
    fill: float = 0.75,
) -> CSRMatrix:
    """Banded FEM/device-simulation matrix (ohne2/barrier2-3/nxp1 family)."""
    rng = _rng(seed)
    offsets = np.arange(-band, band + 1)
    rows = []
    cols = []
    for off in offsets:
        keep = rng.random(n) < fill
        r = np.nonzero(keep)[0]
        c = r + off
        ok = (c >= 0) & (c < n)
        rows.append(r[ok])
        cols.append(c[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = rng.standard_normal(rows.size)
    return csr_from_coo(COOMatrix(rows, cols, data, (n, n)))


def dense_block(
    n: int,
    *,
    seed: int = 0,
    block: int = 512,
    n_blocks: int = 12,
    background: float = 8.0,
) -> CSRMatrix:
    """Matrix with a few dense blocks plus sparse background (mip1 family)."""
    rng = _rng(seed)
    rows = []
    cols = []
    for _ in range(n_blocks):
        r0 = rng.integers(0, max(1, n - block))
        c0 = rng.integers(0, max(1, n - block))
        density = 0.35
        cnt = int(block * block * density)
        rows.append(r0 + rng.integers(0, block, size=cnt))
        cols.append(c0 + rng.integers(0, block, size=cnt))
    bg = int(n * background)
    rows.append(rng.integers(0, n, size=bg))
    cols.append(rng.integers(0, n, size=bg))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = rng.standard_normal(rows.size)
    return csr_from_coo(COOMatrix(rows, cols, data, (n, n)))


def uniform_random(n: int, density: float, *, seed: int = 0) -> CSRMatrix:
    rng = _rng(seed)
    nnz = int(n * n * density)
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    data = rng.standard_normal(nnz)
    return csr_from_coo(COOMatrix(rows, cols, data, (n, n)))


# ---------------------------------------------------------------------------
# The benchmark suite: scaled-down analogues of the paper's Table I.
# Sizes are reduced ~8-32x so the full benchmark sweep runs on a single CPU
# host; the structural characteristics (degree distributions, banding,
# rails) match the originals.  ``scale`` in benchmarks can raise them.
# ---------------------------------------------------------------------------

SUITE_SPECS: Dict[str, Callable[[int], CSRMatrix]] = {
    # circuit family (ASIC_320k / ASIC_680k / rajat21/24/29/30)
    "m1_asic320k": lambda s: circuit(40_000, seed=1 + s, avg_offdiag=4.9),
    "m2_asic680k": lambda s: circuit(85_000, seed=2 + s, avg_offdiag=4.6),
    "m3_barrier2": lambda s: banded_fem(14_000, seed=3 + s, band=9, fill=0.95),
    # kron_g500 family (power-law)
    "m4_kron16": lambda s: rmat(1 << 16, 5_200_000, seed=4 + s),
    "m5_kron17": lambda s: rmat(1 << 17, 10_800_000, seed=5 + s),
    "m8_mip1": lambda s: dense_block(8_000, seed=8 + s, block=384, n_blocks=10),
    "m9_nxp1": lambda s: banded_fem(52_000, seed=9 + s, band=3, fill=0.9),
    "m10_ohne2": lambda s: banded_fem(22_000, seed=10 + s, band=19, fill=0.95),
    "m11_rajat21": lambda s: circuit(51_000, seed=11 + s, avg_offdiag=3.4),
    "m14_rajat30": lambda s: circuit(80_000, seed=14 + s, avg_offdiag=8.7),
}


def paper_suite(seed: int = 0) -> Dict[str, CSRMatrix]:
    """Generate the full scaled Table-I analogue suite."""
    return {name: gen(seed) for name, gen in SUITE_SPECS.items()}
