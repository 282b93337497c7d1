"""High-level SpMV API: format construction + dispatch to backends.

``spmv`` dispatches on the container type:

* :class:`~repro_torch.core.formats.CSRMatrix`  — CSR baselines: torch's
  sparse-CSR product on the device (``backend="auto"``, ``"cuda"`` or
  ``"torch"``; cuSPARSE on the card), the port's counterpart of the JAX
  package's jnp segment-sum device path (Algorithm 1), or the numpy
  reference (``"reference"``);
* :class:`~repro_torch.core.hbp.HBPMatrix`      — the faithful
  GPU-semantics reference (Algorithm 3), numpy on the host whatever the
  backend, as in the JAX package;
* :class:`~repro_torch.core.tile.HBPTiles`      — the production path:
  the fused CUDA kernels through :mod:`repro_torch.kernels.ops`
  (``"auto"`` or ``"cuda"``; their plain PyTorch versions when
  ``device="cpu"``), or the einsum oracle (``"torch"``).

The backend names map onto the JAX package's (``repro.core.spmv``):
``"cuda"`` is its ``"pallas"`` (the hand-written kernels), ``"torch"`` its
``"jnp"`` (plain tensor code on the device) and ``"reference"`` its
``"reference"`` (numpy).  ``"auto"`` picks the device path of every
container but the numpy ``HBPMatrix``; the JAX package's ``"auto"`` keeps
a ``CSRMatrix`` on the host, while here it runs on the device, so that
every device path runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import warnings
from typing import Literal

import numpy as np
import torch

from .formats import CSRMatrix
from .hbp import HBPMatrix, build_hbp, hbp_spmv_reference
from .partition import PartitionConfig
from .tile import HBPTiles, build_tiles

__all__ = [
    "spmv",
    "spmm",
    "csr_spmv_torch",
    "csr_spmm_torch",
    "build_hbp",
    "build_tiles",
    "PartitionConfig",
    "BACKENDS",
]

BACKENDS = ("auto", "cuda", "torch", "reference")


def _csr_tensor(indptr, indices, data, n_rows: int, n_cols: int, device) -> torch.Tensor:
    # CSRMatrix validated its arrays on construction; the beta notice of
    # torch's sparse-CSR layout says nothing about this use
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
        return torch.sparse_csr_tensor(
            torch.as_tensor(indptr, dtype=torch.int64, device=device),
            torch.as_tensor(indices, dtype=torch.int64, device=device),
            torch.as_tensor(data, dtype=torch.float32, device=device),
            size=(n_rows, n_cols),
            check_invariants=False,
        )


def csr_spmv_torch(indptr, indices, data, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Device CSR SpMV (Algorithm 1) on x's device: torch's sparse-CSR
    product, cuSPARSE on the card — the CSR baseline of Figs. 8/10 (the
    JAX package's ``csr_spmv_jnp``)."""
    A = _csr_tensor(indptr, indices, data, n_rows, x.shape[0], x.device)
    return A @ x


def csr_spmm_torch(indptr, indices, data, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Device CSR multi-RHS SpMM (``x: [n_cols, k]``) on x's device — the
    CSR baseline of the SpMM kernel (the JAX package's ``csr_spmm_jnp``)."""
    A = _csr_tensor(indptr, indices, data, n_rows, x.shape[0], x.device)
    return A @ x


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")


def _device_x(x, device) -> torch.Tensor:
    from repro_torch.kernels.ops import resolve_device

    return torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))


def _host_x(x) -> np.ndarray:
    """x for the numpy references: a tensor on any device is copied back."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def spmv(
    A,
    x,
    *,
    backend: Literal["auto", "cuda", "torch", "reference"] = "auto",
    device=None,
):
    """Sparse matrix–vector product ``A @ x``.

    A 2-D ``x`` (an ``[n, k]`` block of right-hand sides) routes to
    :func:`spmm`, which serves all ``k`` columns from one kernel launch.
    A ``[n, 1]`` column vector is a 2-D input: it takes the SpMM path and
    comes back as ``[n, 1]``, never silently squeezed to ``[n]``.
    """
    _check_backend(backend)
    # np.ndim (not getattr) so nested-list inputs dispatch by their true
    # rank instead of falling through to the 1-D path
    if np.ndim(x) == 2:
        return spmm(A, x, backend=backend, device=device)
    if np.ndim(x) != 1:
        raise ValueError(f"spmv expects a 1-D or 2-D x, got ndim={np.ndim(x)}")
    if isinstance(A, CSRMatrix):
        if backend == "reference":
            return A.matvec(_host_x(x))
        return csr_spmv_torch(A.indptr, A.indices, A.data, _device_x(x, device), A.n_rows)
    if isinstance(A, HBPMatrix):
        return hbp_spmv_reference(A, _host_x(x))
    if isinstance(A, HBPTiles):
        from repro_torch.kernels import ops

        if backend in ("auto", "cuda"):
            return ops.hbp_spmv(A, _device_x(x, device), device=device)
        if backend == "torch":
            return ops.hbp_spmv(A, _device_x(x, device), strategy="reference", device=device)
        raise ValueError(f"unsupported backend {backend!r} for HBPTiles")
    raise TypeError(f"unsupported matrix type {type(A)!r}")


def spmm(
    A,
    x,
    *,
    backend: Literal["auto", "cuda", "torch", "reference"] = "auto",
    device=None,
):
    """Sparse matrix–matrix product ``Y = A @ X`` with ``X: [n_cols, k]``.

    Dispatches like :func:`spmv`; on :class:`HBPTiles` it launches the
    multi-RHS SpMM kernel (one tile-stream pass for all ``k`` columns).
    ``k = 1`` is a valid block width: the result keeps its ``[n, 1]`` shape.
    """
    _check_backend(backend)
    if np.ndim(x) != 2:
        raise ValueError(
            f"spmm expects x of shape [n_cols, k], got ndim={np.ndim(x)}; "
            "use spmv for 1-D right-hand sides"
        )
    if isinstance(A, CSRMatrix):
        if backend == "reference":
            xs = _host_x(x)
            return np.stack([A.matvec(xs[:, j]) for j in range(xs.shape[1])], axis=1)
        return csr_spmm_torch(A.indptr, A.indices, A.data, _device_x(x, device), A.n_rows)
    if isinstance(A, HBPMatrix):
        xs = _host_x(x)
        return np.stack(
            [hbp_spmv_reference(A, xs[:, j]) for j in range(xs.shape[1])], axis=1
        )
    if isinstance(A, HBPTiles):
        from repro_torch.kernels import ops

        if backend in ("auto", "cuda"):
            return ops.hbp_spmm(A, _device_x(x, device), device=device)
        if backend == "torch":
            return ops.hbp_spmm(A, _device_x(x, device), strategy="reference", device=device)
        raise ValueError(f"unsupported backend {backend!r} for HBPTiles")
    raise TypeError(f"unsupported matrix type {type(A)!r}")
