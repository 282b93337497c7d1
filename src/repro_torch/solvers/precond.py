"""Preconditioners as :class:`LinearOperator` compositions.

A preconditioner ``M ~= A^{-1}`` enters the Krylov loops (``cg``,
``bicgstab``) as just another operator application, so it composes with
every matrix container the solvers accept — and it stays inside the
solver loop's chunks like the SpMV itself, with no host sync.

:func:`jacobi` is the diagonal (point-Jacobi) preconditioner.  Its input
is deliberately flexible: the diagonal is host-resident anyway at
tile-build time (the CSR matrix is on the host while the HBP tiles are
constructed; the serving registry snapshots it into the plan), so there is
never a reason to recover it from the device format.

:func:`block_jacobi` is the block variant: invert dense diagonal blocks
``A[idx, idx]`` over a partition of the index set and apply them batched.
Any disjoint partition is valid — contiguous ``block_size`` runs are the
classic choice, and :func:`hash_group_blocks` derives the partition from
the HBP tile format itself (one block per hash group, the ``[group,
group]`` granularity the kernels already reduce over).  Off-block
couplings are simply dropped, so the better the partition matches the
matrix's strong couplings, the closer M is to A^{-1}.

Both are staged on ``device`` (default: the card) at construction.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.formats import CSRMatrix, csr_from_dense
from repro_torch.core.tile import HBPTiles
from repro_torch.kernels import ops

from .operator import LinearOperator

__all__ = ["jacobi", "block_jacobi", "hash_group_blocks"]


def jacobi(A, *, device=None) -> LinearOperator:
    """Jacobi preconditioner ``M = diag(A)^{-1}`` as a LinearOperator.

    ``A`` may be a :class:`CSRMatrix` (diagonal extracted on the host), a
    dense 2-D array, or the diagonal itself as a 1-D vector — e.g. the
    one a serving :class:`~repro_torch.serving.registry.MatrixPlan`
    captured at admission.  Zero diagonal entries fall back to the
    identity (scale 1) so the operator is always well defined.
    """
    if isinstance(A, CSRMatrix):
        diag = A.diagonal()
    else:
        arr = A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        if arr.ndim == 2:
            diag = np.diagonal(arr)
        elif arr.ndim == 1:
            diag = arr
        else:
            raise ValueError(
                f"jacobi expects a matrix or a 1-D diagonal, got ndim={arr.ndim}"
            )
    dev = ops.resolve_device(device)
    inv = torch.as_tensor(
        np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0), dtype=torch.float32
    ).to(dev)
    n = inv.shape[0]
    return LinearOperator(
        (n, n),
        matvec=lambda x: inv * x,
        matmat=lambda x: inv[:, None] * x,
        device=dev,
    )


def hash_group_blocks(tiles: HBPTiles) -> list:
    """Index partition induced by the HBP hash: one block per row group.

    ``tiles.perm`` maps hashed slots to original rows over the padded row
    space; consecutive runs of ``cfg.group`` slots are exactly the row
    groups the kernels reduce over.  Padding rows are dropped, empty
    groups skipped.  Because the nonlinear hash clusters rows of similar
    nnz, these blocks capture the "rows that behave alike" structure the
    format was built around — the natural granularity for a tile-format
    block preconditioner.
    """
    n_rows = tiles.shape[0]
    G = tiles.cfg.group
    slots = np.asarray(tiles.perm).reshape(-1, G)
    blocks = []
    for grp in slots:
        idx = np.sort(grp[grp < n_rows])
        if idx.size:
            blocks.append(idx.astype(np.int64))
    return blocks


def _dense_blocks_from_csr(
    csr: CSRMatrix, blocks: Sequence[np.ndarray], bmax: int
) -> np.ndarray:
    """Gather A[idx, idx] for every block in one pass over the nnz."""
    n = csr.shape[0]
    bid = np.full(n, -1, dtype=np.int64)  # block id per row, -1 = unassigned
    lpos = np.zeros(n, dtype=np.int64)  # local position within the block
    for b, idx in enumerate(blocks):
        bid[idx] = b
        lpos[idx] = np.arange(idx.size)
    rows = np.repeat(np.arange(n), csr.row_nnz())
    cols = csr.indices
    mask = (bid[rows] >= 0) & (bid[rows] == bid[cols])
    dense = np.zeros((len(blocks), bmax, bmax), dtype=np.float64)
    np.add.at(
        dense, (bid[rows[mask]], lpos[rows[mask]], lpos[cols[mask]]), csr.data[mask]
    )
    return dense


def block_jacobi(
    A,
    *,
    block_size: Optional[int] = None,
    blocks: Optional[Sequence[np.ndarray]] = None,
    device=None,
) -> LinearOperator:
    """Block-Jacobi preconditioner ``M = blockdiag(A[idx, idx])^{-1}``.

    ``A`` is a :class:`CSRMatrix` or a dense 2-D array (the tile format
    holds permuted values only — for a tile-derived partition pass the CSR
    as ``A`` with ``blocks=hash_group_blocks(tiles)``).  The partition
    comes from ``blocks`` (disjoint index arrays; rows left out fall back
    to point Jacobi on their diagonal) or ``block_size`` (contiguous runs,
    default 8).

    Each block is inverted densely on the host at build time —
    ``[group, group]`` solves are trivial next to tile construction — and
    applied batched on ``device``: gather to ``[n_blocks, bmax, k]``, one
    ``torch.bmm`` against the padded inverse stack, and a scatter back.
    The blocks are disjoint, so the scatter is a copy of each block's
    live slots (``index_copy``, no atomics); padded slots carry the mask
    of 0.  Singular blocks fall back to the pseudo-inverse.
    """
    if isinstance(A, HBPTiles):
        raise TypeError(
            "block_jacobi needs the host CSR matrix; derive the partition "
            "with blocks=hash_group_blocks(tiles) and pass the CSR as A"
        )
    if isinstance(A, CSRMatrix):
        csr = A
    else:
        arr = A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
            raise ValueError(f"block_jacobi expects a square matrix, got {arr.shape}")
        csr = csr_from_dense(arr)
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"block_jacobi expects a square matrix, got {csr.shape}")

    if blocks is None:
        bs = block_size or 8
        blocks = [np.arange(lo, min(lo + bs, n)) for lo in range(0, n, bs)]
    else:
        blocks = [np.asarray(b, dtype=np.int64) for b in blocks if len(b)]
        flat = np.concatenate(blocks) if blocks else np.zeros(0, np.int64)
        if flat.size != np.unique(flat).size:
            raise ValueError("blocks must be disjoint")
        if flat.size and (flat.min() < 0 or flat.max() >= n):
            raise ValueError(f"block indices outside [0, {n})")
    if not blocks:
        return jacobi(csr, device=device)

    bmax = max(len(b) for b in blocks)
    dense = _dense_blocks_from_csr(csr, blocks, bmax)

    # pad unused local slots (short blocks) with zeros: padded slots are
    # masked on the way in and never scattered back
    inv = np.zeros_like(dense)
    for b, idx in enumerate(blocks):
        s = idx.size
        blk = dense[b, :s, :s]
        # zero diagonal entries would make even the 1x1 case singular;
        # match jacobi()'s identity fallback at the scalar level
        dzero = np.diagonal(blk) == 0
        if dzero.any():
            blk = blk + np.diag(np.where(dzero, 1.0, 0.0))
        try:
            inv_blk = np.linalg.inv(blk)
        except np.linalg.LinAlgError:
            inv_blk = np.linalg.pinv(blk)
        inv[b, :s, :s] = inv_blk

    # device-side application: gather -> batched matmul -> scatter
    idx_pad = np.zeros((len(blocks), bmax), dtype=np.int64)
    mask = np.zeros((len(blocks), bmax), dtype=np.float32)
    for b, idx in enumerate(blocks):
        idx_pad[b, : idx.size] = idx
        mask[b, : idx.size] = 1.0
    live = np.flatnonzero(mask.reshape(-1))  # slots of idx_pad that hold a row
    covered = np.zeros(n, dtype=bool)
    covered[np.concatenate(blocks)] = True
    # rows no block claims: point Jacobi on their diagonal (identity if 0)
    diag = csr.diagonal()
    rest = np.where(
        covered, 0.0, np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    )

    dev = ops.resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    inv_t = put(inv, torch.float32)
    idx_t = put(idx_pad.reshape(-1), torch.int64)
    mask_t = put(mask, torch.float32)[..., None]
    live_t = put(live, torch.int64)
    dest_t = put(idx_pad.reshape(-1)[live], torch.int64)
    rest_t = put(rest, torch.float32)[:, None]

    def matmat(x: torch.Tensor) -> torch.Tensor:
        k = x.shape[-1]
        xg = x.index_select(0, idx_t).view(*mask_t.shape[:2], k) * mask_t  # [nb, bmax, k]
        yg = torch.bmm(inv_t, xg) * mask_t
        y = torch.zeros_like(x).index_copy_(
            0, dest_t, yg.reshape(-1, k).index_select(0, live_t))
        return y + rest_t * x

    return LinearOperator(
        (n, n),
        matvec=lambda x: matmat(x[:, None])[:, 0],
        matmat=matmat,
        device=dev,
    )
