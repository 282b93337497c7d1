"""Sparse-matrix containers used throughout the library.

Host-side (numpy) containers hold the matrix during preprocessing — format
construction, 2D partitioning, hash reordering — mirroring how production
frameworks (cuSPARSE, MaxText input pipelines) keep format conversion on the
host.  Device-side containers (see :mod:`repro.core.tile`) are pytrees of
``jnp`` arrays consumed by the Pallas kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["COOMatrix", "CSRMatrix", "csr_from_dense", "csr_from_coo"]


@dataclasses.dataclass
class COOMatrix:
    """Coordinate format: explicit (row, col, value) triples."""

    row: np.ndarray  # int32[nnz]
    col: np.ndarray  # int32[nnz]
    data: np.ndarray  # float[nnz]
    shape: Tuple[int, int]

    def __post_init__(self) -> None:
        self.row = np.asarray(self.row, dtype=np.int64)
        self.col = np.asarray(self.col, dtype=np.int64)
        self.data = np.asarray(self.data)
        if not (self.row.shape == self.col.shape == self.data.shape):
            raise ValueError("row/col/data must have identical shapes")

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def to_csr(self) -> "CSRMatrix":
        return csr_from_coo(self)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        np.add.at(out, (self.row, self.col), self.data)
        return out


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row.  ``indices`` are sorted within each row.

    This is the input format of every preprocessing routine in this library,
    exactly as in the paper (Algorithm 2 consumes ``csr_ptr``/``csr_col``).
    """

    indptr: np.ndarray  # int64[n_rows + 1]
    indices: np.ndarray  # int64[nnz], column ids, sorted per row
    data: np.ndarray  # float[nnz]
    shape: Tuple[int, int]

    def __post_init__(self) -> None:
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int64)
        self.data = np.asarray(self.data)
        n_rows, _ = self.shape
        if self.indptr.shape != (n_rows + 1,):
            raise ValueError(
                f"indptr has shape {self.indptr.shape}, expected {(n_rows + 1,)}"
            )
        if self.indptr[-1] != self.indices.size:
            raise ValueError("indptr[-1] must equal nnz")

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row_nnz(self) -> np.ndarray:
        """Number of nonzeros per row — the input of the nonlinear hash."""
        return np.diff(self.indptr)

    def row_slice(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        out[rows, self.indices] = self.data
        return out

    def to_coo(self) -> COOMatrix:
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        return COOMatrix(rows, self.indices.copy(), self.data.copy(), self.shape)

    def diagonal(self) -> np.ndarray:
        """Main diagonal as a dense ``[min(shape)]`` vector (absent = 0).

        Host-resident by construction — this is what the Jacobi
        preconditioner and the serving registry capture at tile-build time.
        """
        n = min(self.shape)
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        mask = (rows == self.indices) & (rows < n)
        out = np.zeros(n, dtype=self.data.dtype)
        # accumulate: duplicate entries sum, matching matvec's semantics
        np.add.at(out, rows[mask], self.data[mask])
        return out

    def transpose(self) -> "CSRMatrix":
        """Aᵀ as a fresh CSR (the CSC view of A, re-read as rows).

        Index-sorted and round-trip exact: the conversion is a stable
        counting sort over (col, row), so ``A.transpose().transpose()``
        reproduces ``indptr``/``indices``/``data`` bit for bit — no
        duplicate merging, no value reordering within ties.  This is the
        host-side half of the differentiable aggregation path (the VJP of
        ``A @ X`` is ``Aᵀ @ Ḡ``), but it stands alone as format API.
        """
        n_rows, n_cols = self.shape
        rows = np.repeat(np.arange(n_rows), self.row_nnz())
        # stable sort by column, then row: Aᵀ's rows come out in order with
        # sorted inner indices (the rows of A, ascending per column)
        order = np.lexsort((rows, self.indices))
        indptr = np.zeros(n_cols + 1, dtype=np.int64)
        np.add.at(indptr, self.indices + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRMatrix(indptr, rows[order], self.data[order], (n_cols, n_rows))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference CSR SpMV (Algorithm 1 of the paper), vectorised."""
        prod = self.data * x[self.indices]
        out = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(out, np.repeat(np.arange(self.n_rows), self.row_nnz()), prod)
        return out


def csr_from_coo(coo: COOMatrix, *, sum_duplicates: bool = True) -> CSRMatrix:
    """Convert COO → CSR with per-row sorted column indices."""
    n_rows, n_cols = coo.shape
    order = np.lexsort((coo.col, coo.row))
    row, col, data = coo.row[order], coo.col[order], coo.data[order]
    if sum_duplicates and row.size:
        key_change = np.empty(row.size, dtype=bool)
        key_change[0] = True
        key_change[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
        group = np.cumsum(key_change) - 1
        row = row[key_change]
        col = col[key_change]
        data = np.bincount(group, weights=data).astype(data.dtype)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(indptr, col, data, coo.shape)


def csr_from_dense(dense: np.ndarray, *, tol: float = 0.0) -> CSRMatrix:
    mask = np.abs(dense) > tol
    row, col = np.nonzero(mask)
    coo = COOMatrix(row, col, dense[mask], dense.shape)
    return csr_from_coo(coo, sum_duplicates=False)
