"""Power iteration and PageRank on the HBP operator.

PageRank is the canonical "SpMV in a loop" workload (the SpMV surveys
benchmark formats inside exactly this kernel): every iteration is one
product with the column-stochastic transition matrix.  With ``k``
personalization vectors the iteration state is an ``[n, k]`` block and
each step is ONE multi-RHS SpMM launch — the tile stream is read once for
all ``k`` rankings, which is where the HBP format's preprocessing cost
amortizes fastest.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.formats import COOMatrix, CSRMatrix, csr_from_coo

from .base import TINY, EigResult, SolveResult, history_init, history_set, l2norm
from .base import while_loop
from .operator import aslinearoperator

__all__ = ["power_iteration", "transition_matrix", "pagerank"]


def power_iteration(
    A,
    *,
    v0=None,
    tol: float = 1e-6,
    maxiter: int = 1000,
    seed: int = 0,
) -> EigResult:
    """Dominant eigenpair of ``A`` by the power method.

    Converges when ``||A v - lambda v|| <= tol * |lambda|``.  ``v0``
    defaults to a deterministic random unit vector (``seed``), the one
    the JAX package draws.
    """
    op = aslinearoperator(A)
    n = op.shape[0]
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(n)
    v = op.vector(v0)
    v = v / torch.clamp(l2norm(v), min=TINY)

    w = op(v)
    lam = torch.sum(v * w, dim=0)
    resid = l2norm(w - lam * v)
    hist = history_init(maxiter, lam)

    def cond(state):
        _, lam, resid, _ = state
        return resid > tol * torch.abs(lam)

    def body(k, state):
        v, _, _, hist = state
        w = op(v)
        v = w / torch.clamp(l2norm(w), min=TINY)
        w = op(v)
        lam = torch.sum(v * w, dim=0)  # Rayleigh quotient of the unit iterate
        resid = l2norm(w - lam * v)
        return v, lam, resid, history_set(hist, k + 1, lam)

    k, (v, lam, resid, hist) = while_loop(cond, body, (v, lam, resid, hist), maxiter)
    return EigResult(
        eigenvalue=lam,
        eigenvector=v,
        converged=resid <= tol * torch.abs(lam),
        iterations=k,
        residual=resid,
        history=hist,
    )


def transition_matrix(adj: CSRMatrix) -> tuple[CSRMatrix, np.ndarray]:
    """Column-stochastic PageRank matrix from an adjacency matrix.

    Edge weights are ``|a_ij|`` normalised by out-weight, then transposed
    so that ``p_new = M @ p`` propagates rank along edges.  Returns
    ``(M, dangling)`` where ``dangling`` is the float indicator of rows
    with no out-edges (their mass is redistributed by :func:`pagerank`).
    Host-side preprocessing, like the HBP format build it feeds.
    """
    n = adj.n_rows
    if adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    w = np.abs(adj.data)
    out_weight = np.zeros(n)
    rows = np.repeat(np.arange(n), adj.row_nnz())
    np.add.at(out_weight, rows, w)
    dangling = (out_weight == 0).astype(np.float32)
    norm = w / np.where(out_weight > 0, out_weight, 1.0)[rows]
    # transpose by swapping the roles of row and column in COO
    M = csr_from_coo(
        COOMatrix(adj.indices.copy(), rows, norm, (n, n)), sum_duplicates=True
    )
    return M, dangling


def pagerank(
    M,
    *,
    damping: float = 0.85,
    personalization=None,
    dangling=None,
    tol: float = 1e-8,
    maxiter: int = 200,
) -> SolveResult:
    """PageRank by power iteration on the column-stochastic ``M``.

    ``M`` is anything :func:`aslinearoperator` accepts — build it with
    :func:`transition_matrix` and convert to :class:`HBPTiles` for the
    kernel path.  ``personalization`` may be a single ``[n]`` vector or an
    ``[n, k]`` block (k personalized rankings per launch, via the SpMM
    kernel); it is normalised to sum 1 per column.  Dangling mass is
    redistributed according to the personalization, as in NetworkX.
    Converges on the per-column L1 change ``||p' - p||_1 <= tol * n``.
    """
    op = aslinearoperator(M)
    n = op.shape[0]
    if personalization is None:
        v = torch.full((n,), 1.0 / n, dtype=torch.float32, device=op.device)
    else:
        v = op.vector(personalization)
        v = v / torch.sum(v, dim=0)
    dang = (
        torch.zeros((n,), dtype=torch.float32, device=op.device)
        if dangling is None else op.vector(dangling)
    )

    # slot 0 is the pre-iteration error carry (inf, like the loop init), so
    # the finite-prefix history convention matches the linear solvers
    err = torch.full(v.shape[1:], math.inf, dtype=torch.float32, device=op.device)
    hist = history_init(maxiter, err)
    thresh = tol * n

    def cond(state):
        return torch.any(state[1] > thresh)

    def body(k, state):
        p, _, hist = state
        spread = op(p)  # one SpMV/SpMM launch
        p_new = damping * (spread + (dang @ p) * v) + (1.0 - damping) * v
        err = torch.sum(torch.abs(p_new - p), dim=0)
        return p_new, err, history_set(hist, k + 1, err)

    k, (p, err, hist) = while_loop(cond, body, (v, err, hist), maxiter)
    return SolveResult(
        x=p,
        converged=torch.all(err <= thresh),
        iterations=k,
        residual=err,
        history=hist,
    )
