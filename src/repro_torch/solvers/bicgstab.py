"""BiCGSTAB (van der Vorst) — the nonsymmetric workhorse.

The paper's matrix families (circuit simulation, semiconductor FEM) are
nonsymmetric, so CG does not apply to them directly; BiCGSTAB is the
standard Krylov method production circuit solvers run on exactly these
matrices.  Two operator applications per iteration; like :func:`cg` it is
vectorised over an ``[n, k]`` RHS block (per-column scalars, shared SpMM
launches).

``M`` right-preconditions the iteration (``A M`` Krylov space, update
directions mapped through ``M`` before entering ``x``): the residual keeps
its plain meaning ``b - A x``, so the convergence test is unchanged, and
``M=None`` reduces exactly to the unpreconditioned update.
"""
from __future__ import annotations

import torch

from .base import TINY, SolveResult, emit_history, history_init, history_set, l2norm, safe_div
from .base import while_loop
from .operator import aslinearoperator, preconditioner

__all__ = ["bicgstab"]


def bicgstab(
    A,
    b,
    *,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 400,
    M=None,
    record_history: bool = True,
) -> SolveResult:
    """Solve ``A x = b`` for general (nonsymmetric) ``A``.

    ``M`` (optional) is a right preconditioner ``M ~= A^{-1}``, e.g.
    :func:`~repro_torch.solvers.precond.jacobi` — one extra operator
    product per operator application.  On Krylov breakdown (``rho`` or
    ``omega`` hitting exactly zero — residual already at machine floor)
    the guarded divisions freeze the iterate instead of producing NaNs,
    and the loop exits on the residual test or ``maxiter``.

    ``record_history`` as in :func:`~repro_torch.solvers.cg.cg`: ``True``
    carries per-iteration residual norms (and streams them to
    ``repro_torch.obs`` post-loop), ``False`` carries one slot.
    """
    op = aslinearoperator(A)
    apply_M = preconditioner(M, op)
    b = op.vector(b)
    x = torch.zeros_like(b) if x0 is None else op.vector(x0)
    bnorm = torch.clamp(l2norm(b), min=TINY)
    thresh = tol * bnorm

    r = b - op(x)
    rhat = r  # shadow residual, fixed
    ones = torch.ones(r.shape[1:], dtype=torch.float32, device=r.device)
    v = torch.zeros_like(r)
    p = torch.zeros_like(r)
    rnorm = l2norm(r)
    hist = history_init(maxiter if record_history else 0, rnorm)

    def cond(state):
        return torch.any(state[7] > thresh)

    def body(k, state):
        x, r, p, v, rho, alpha, omega, _, hist = state
        rho_new = torch.sum(rhat * r, dim=0)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        phat = apply_M(p)
        v = op(phat)
        alpha = safe_div(rho_new, torch.sum(rhat * v, dim=0))
        s = r - alpha * v
        shat = apply_M(s)
        t = op(shat)
        omega = safe_div(torch.sum(t * s, dim=0), torch.sum(t * t, dim=0))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rnorm = l2norm(r)
        return x, r, p, v, rho_new, alpha, omega, rnorm, history_set(hist, k + 1, rnorm)

    state = (x, r, p, v, ones, ones, ones, rnorm, hist)
    k, (x, *_, res, hist) = while_loop(cond, body, state, maxiter)
    emit_history("bicgstab", hist)
    return SolveResult(
        x=x,
        converged=torch.all(res <= thresh),
        iterations=k,
        residual=res,
        history=hist,
    )
