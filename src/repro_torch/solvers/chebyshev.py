"""Chebyshev iteration / polynomial smoothing on the HBP operator.

Given spectrum bounds ``0 < lam_min <= lam(A) <= lam_max`` for SPD ``A``,
Chebyshev iteration reaches CG-like convergence WITHOUT inner products —
every iteration is exactly one operator application plus AXPYs.  That
makes it the multigrid smoother of choice and, for this library, the
purest "SpMV is the whole workload" solver: no reductions compete with
the kernel launch in the profile.  Vectorised over ``[n, k]`` RHS blocks
like :func:`~repro_torch.solvers.cg.cg` (the scalars are spectral, shared
by every column).

:func:`estimate_spectrum` bootstraps the bounds with a short power
iteration (``lam_max`` slightly inflated for safety, ``lam_min`` as a
fixed fraction — the standard smoothing convention).
"""
from __future__ import annotations

import torch

from .base import TINY, SolveResult, emit_history, history_init, history_set, l2norm
from .base import while_loop
from .operator import aslinearoperator

__all__ = ["chebyshev", "estimate_spectrum"]


def estimate_spectrum(
    A, *, maxiter: int = 50, lower_frac: float = 0.1, safety: float = 1.05
) -> tuple[float, float]:
    """(lam_min, lam_max) bounds for :func:`chebyshev` via power iteration.
    Reads the eigenvalue to the host once."""
    from .power import power_iteration

    res = power_iteration(A, maxiter=maxiter, tol=1e-4)
    lam_max = float(res.eigenvalue) * safety
    return lower_frac * lam_max, lam_max


def chebyshev(
    A,
    b,
    *,
    lam_min: float,
    lam_max: float,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    record_history: bool = True,
) -> SolveResult:
    """Solve / smooth ``A x = b`` with Chebyshev acceleration.

    With ``tol=0`` it runs exactly ``maxiter`` iterations — the fixed
    polynomial degree of a multigrid smoothing pass.

    ``record_history`` as in :func:`~repro_torch.solvers.cg.cg`: ``True``
    carries per-iteration residual norms (and streams them to
    ``repro_torch.obs`` post-loop), ``False`` carries one slot.
    """
    if not 0 < lam_min < lam_max:
        raise ValueError(f"need 0 < lam_min < lam_max, got [{lam_min}, {lam_max}]")
    op = aslinearoperator(A)
    b = op.vector(b)
    x = torch.zeros_like(b) if x0 is None else op.vector(x0)
    bnorm = torch.clamp(l2norm(b), min=TINY)
    thresh = tol * bnorm

    theta = 0.5 * (lam_max + lam_min)  # spectrum centre
    delta = 0.5 * (lam_max - lam_min)  # spectrum half-width
    sigma = theta / delta

    r = b - op(x)
    d = r / theta
    rnorm = l2norm(r)
    hist = history_init(maxiter if record_history else 0, rnorm)

    def cond(state):
        return torch.any(state[4] > thresh)

    def body(k, state):
        x, r, d, rho, _, hist = state
        x = x + d
        r = r - op(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rnorm = l2norm(r)
        return x, r, d, rho_new, rnorm, history_set(hist, k + 1, rnorm)

    rho = torch.full((), 1.0 / sigma, dtype=torch.float32, device=b.device)
    state = (x, r, d, rho, rnorm, hist)
    k, (x, r, d, rho, res, hist) = while_loop(cond, body, state, maxiter)
    emit_history("chebyshev", hist)
    return SolveResult(
        x=x,
        converged=torch.all(res <= thresh),
        iterations=k,
        residual=res,
        history=hist,
    )
