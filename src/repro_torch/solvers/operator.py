"""The operator abstraction every solver dispatches through.

A :class:`LinearOperator` is ``y = A @ x`` on one device: its ``matvec`` /
``matmat`` closures hold only tensors already on that device (staged tile
formats, CSR arrays, dense matrices), so a solver loop built on it never
copies between host and card per iteration, and the solvers put ``b``,
``x0`` and their other vectors on the operator's ``device``.

:func:`aslinearoperator` adapts every container in the library:

* :class:`~repro_torch.core.tile.HBPTiles` — the production path: the
  hand-written HBP kernels (SpMV for single vectors, the one-launch SpMM
  for ``[n, k]`` blocks) under ``strategy``.  The host tiles are staged to
  the device ONCE at operator construction; solver iterations touch only
  :class:`~repro_torch.kernels.ops.DeviceTiles`.
* :class:`~repro_torch.core.formats.CSRMatrix` — the CSR baseline
  (``csr_spmv_torch``/``csr_spmm_torch``, cuSPARSE on the card) for
  apples-to-apples workload benchmarks.
* dense ``np.ndarray`` / ``torch.Tensor`` — ``torch.matmul``, the oracle
  solvers are validated against.

``device=None`` means the card and raises without one (pass
``device="cpu"`` for the plain PyTorch versions of the kernels).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSRMatrix
from repro_torch.core.spmv import csr_spmm_torch, csr_spmv_torch
from repro_torch.core.tile import HBPTiles
from repro_torch.kernels import ops

__all__ = ["LinearOperator", "aslinearoperator"]


class LinearOperator:
    """Matrix-free ``A``: a shape, a device, and matvec/matmat closures.

    ``matmat`` defaults to column-at-a-time matvec; format-aware adapters
    (HBP tiles) override it with the one-launch SpMM kernel.
    """

    def __init__(
        self,
        shape: Tuple[int, int],
        matvec: Callable[[torch.Tensor], torch.Tensor],
        matmat: Callable[[torch.Tensor], torch.Tensor] | None = None,
        dtype=torch.float32,
        device=None,
    ):
        self.shape = tuple(shape)
        self.dtype = dtype
        dev = ops.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the card a bare "cuda" names, as tensors moved there report it
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._matvec = matvec
        self._matmat = matmat

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for a single vector ``x: [n]``."""
        return self._matvec(x)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for a block of right-hand sides ``X: [n, k]``."""
        if self._matmat is not None:
            return self._matmat(x)
        return torch.stack([self._matvec(x[:, j]) for j in range(x.shape[1])], dim=1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Shape-polymorphic apply: [n] -> matvec, [n, k] -> matmat."""
        return self.matvec(x) if x.dim() == 1 else self.matmat(x)

    def __matmul__(self, x):
        return self(x)

    def vector(self, v) -> torch.Tensor:
        """``v`` (numpy or tensor) as f32 on the operator's device."""
        return torch.as_tensor(v, dtype=torch.float32).to(self.device)


def _from_hbp_tiles(tiles: HBPTiles, *, strategy: str, device) -> LinearOperator:
    ops.check_strategy(strategy)
    dt = ops.device_tiles(tiles, device)  # staged once; iterations reuse it
    return LinearOperator(
        tiles.shape,
        matvec=lambda x: ops.hbp_spmv(dt, x, strategy=strategy),
        matmat=lambda x: ops.hbp_spmm(dt, x, strategy=strategy),
        device=dt.device,
    )


def _from_csr(csr: CSRMatrix, device) -> LinearOperator:
    dev = ops.resolve_device(device)
    indptr = torch.as_tensor(csr.indptr, dtype=torch.int64).to(dev)
    indices = torch.as_tensor(csr.indices, dtype=torch.int64).to(dev)
    data = torch.as_tensor(csr.data, dtype=torch.float32).to(dev)
    n_rows = csr.n_rows
    return LinearOperator(
        csr.shape,
        matvec=lambda x: csr_spmv_torch(indptr, indices, data, x, n_rows),
        matmat=lambda x: csr_spmm_torch(indptr, indices, data, x, n_rows),
        device=dev,
    )


def _from_dense(a, device) -> LinearOperator:
    dev = ops.resolve_device(device)
    at = torch.as_tensor(a, dtype=torch.float32).to(dev)
    return LinearOperator(at.shape, matvec=lambda x: at @ x, matmat=lambda x: at @ x,
                          device=dev)


def aslinearoperator(A, *, strategy: str = "fused", device=None) -> LinearOperator:
    """Adapt any supported container to a :class:`LinearOperator`.

    ``strategy`` selects the HBP kernels and applies only to
    :class:`HBPTiles` inputs; ``device`` (default: the card) is where the
    container is staged, and is ignored for a ready operator.
    """
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, HBPTiles):
        return _from_hbp_tiles(A, strategy=strategy, device=device)
    if isinstance(A, CSRMatrix):
        return _from_csr(A, device)
    if isinstance(A, (np.ndarray, torch.Tensor)):
        if A.ndim != 2:
            raise ValueError(f"dense operator must be 2-D, got shape {tuple(A.shape)}")
        return _from_dense(A, device)
    raise TypeError(f"cannot build a LinearOperator from {type(A)!r}")


def preconditioner(M, op: LinearOperator) -> Callable[[torch.Tensor], torch.Tensor]:
    """``M`` as an apply on ``op``'s device (the identity for ``None``)."""
    if M is None:
        return lambda v: v
    M = aslinearoperator(M, device=op.device)
    if M.device != op.device:
        raise ValueError(f"the preconditioner is on {M.device}, the operator on {op.device}")
    return M
