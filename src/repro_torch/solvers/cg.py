"""Conjugate gradients on the HBP operator (SPD systems).

Textbook (preconditioned) CG with two twists that matter here:

* the matrix product is whatever :class:`~repro_torch.solvers.operator.LinearOperator`
  supplies — for :class:`HBPTiles` one kernel launch per iteration;
* ``b`` may be an ``[n, k]`` block of right-hand sides.  The iteration is
  then the *vectorised* CG (independent step lengths per column, one
  shared SpMM launch), so the tile stream is read once per iteration for
  all ``k`` systems instead of ``k`` times.

``M`` is an optional preconditioner ``M ~= A^{-1}`` (e.g.
:func:`~repro_torch.solvers.precond.jacobi`), applied as one extra operator
product per iteration; convergence is still tested on the true residual.
With ``M=None`` the update algebra reduces exactly to plain CG.
"""
from __future__ import annotations

import torch

from .base import TINY, SolveResult, emit_history, history_init, history_set, l2norm, safe_div
from .base import while_loop
from .operator import aslinearoperator, preconditioner

__all__ = ["cg"]


def cg(
    A,
    b,
    *,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    M=None,
    record_history: bool = True,
) -> SolveResult:
    """Solve ``A x = b`` for SPD ``A``; ``b`` is ``[n]`` or ``[n, k]``.

    ``M`` (optional) preconditions the iteration: for SPD ``M ~= A^{-1}``
    this is standard PCG, minimising the same ``A``-norm error over the
    preconditioned Krylov space — badly scaled diagonals (circuit
    matrices) converge in far fewer iterations under :func:`jacobi`.
    Converges when every column satisfies ``||r|| <= tol * ||b||``.
    The loop is :func:`~repro_torch.solvers.base.while_loop`: no host
    sync inside a chunk of iterations.

    ``record_history=True`` (default) carries per-iteration residual
    norms in the loop state (``result.history``, NaN-padded) and — with
    ``repro_torch.obs`` enabled — streams them as a ``solver.cg.residual``
    series after the loop exits; ``False`` carries a single slot instead
    (memory-free long runs, ``history`` holds only the initial norm).
    """
    op = aslinearoperator(A)
    apply_M = preconditioner(M, op)
    b = op.vector(b)
    x = torch.zeros_like(b) if x0 is None else op.vector(x0)
    bnorm = torch.clamp(l2norm(b), min=TINY)
    thresh = tol * bnorm

    r = b - op(x)
    z = apply_M(r)
    rz = torch.sum(r * z, dim=0)
    rnorm = l2norm(r)
    hist = history_init(maxiter if record_history else 0, rnorm)

    def cond(state):
        return torch.any(state[4] > thresh)

    def body(k, state):
        x, r, p, rz, _, hist = state
        Ap = op(p)
        alpha = safe_div(rz, torch.sum(p * Ap, dim=0))
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = safe_div(rz_new, rz)
        p = z + beta * p
        rnorm = l2norm(r)
        return x, r, p, rz_new, rnorm, history_set(hist, k + 1, rnorm)

    state = (x, r, z, rz, rnorm, hist)
    k, (x, r, p, rz, res, hist) = while_loop(cond, body, state, maxiter)
    emit_history("cg", hist)
    return SolveResult(
        x=x,
        converged=torch.all(res <= thresh),
        iterations=k,
        residual=res,
        history=hist,
    )
