"""Shared solver plumbing: results, histories, safe arithmetic, the loop.

Every solver loop runs through :func:`while_loop`, the counterpart of the
JAX package's ``jax.lax.while_loop``: the iteration counter, the
convergence flag and the whole iteration state stay device tensors, and
the host reads the flag once every :data:`CHECK_EVERY` steps, never
inside a chunk of steps.  A step taken after the loop's condition failed
is masked: ``torch.where(active, new, old)`` keeps the old state, and the
counter adds ``active``, so the loop stops at exactly the state and count
at which ``lax.while_loop`` stops.  The state carries a fixed-length
residual history (``maxiter + 1`` slots, NaN beyond the last iteration
actually run); ``record_history=False`` shrinks it to a single slot, and
:func:`history_set` then leaves it as it is (JAX drops an out-of-bounds
scatter; torch would raise).  :func:`emit_history` streams a recorded
history into ``repro_torch.obs`` *after* the loop returns, with one read
to the host, never from inside it.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "SolveResult",
    "EigResult",
    "CHECK_EVERY",
    "l2norm",
    "safe_div",
    "history_init",
    "history_set",
    "emit_history",
    "while_loop",
]

# Steps of a solver loop between two host reads of its convergence flag.
# Up to CHECK_EVERY - 1 masked steps (each with its operator launches) run
# after convergence; the solution, count and history are the same at any
# value (PERF.md has both costs on the card).
CHECK_EVERY = 8

TINY = torch.finfo(torch.float32).tiny


class SolveResult(NamedTuple):
    """Outcome of an iterative linear solve.

    ``x`` has the shape of ``b`` ([n] or [n, k]); ``residual`` and the
    per-iteration ``history`` rows are scalars for a single RHS and
    ``[k]`` vectors for blocked RHS.  Every field is a tensor on the
    operator's device.
    """

    x: torch.Tensor
    converged: torch.Tensor  # bool[] — all RHS columns under tolerance
    iterations: torch.Tensor  # i64[]
    residual: torch.Tensor  # final ||b - A x|| (2-norm), per RHS column
    history: torch.Tensor  # f32[maxiter + 1, ...] residual norms, NaN-padded


class EigResult(NamedTuple):
    """Outcome of an eigenvalue iteration (power method)."""

    eigenvalue: torch.Tensor  # f32[] Rayleigh quotient at exit
    eigenvector: torch.Tensor  # f32[n], unit norm
    converged: torch.Tensor  # bool[]
    iterations: torch.Tensor  # i64[]
    residual: torch.Tensor  # ||A v - lambda v|| at exit
    history: torch.Tensor  # f32[maxiter + 1] eigenvalue estimates, NaN-padded


def l2norm(v: torch.Tensor) -> torch.Tensor:
    """Column-wise 2-norm: scalar for [n], [k] for [n, k]."""
    return torch.sqrt(torch.sum(v * v, dim=0))


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with 0 where den == 0 (Krylov breakdown guard: a zero
    denominator only occurs once the residual is exactly zero).  Where
    den != 0 the quotient is the JAX package's bit for bit; torch divides
    by zero without raising, and the select drops that lane."""
    return torch.where(den != 0, num / den, 0.0)


def history_init(maxiter: int, first_row: torch.Tensor) -> torch.Tensor:
    """[maxiter + 1, ...] NaN history with slot 0 filled, on ``first_row``'s
    device.  ``maxiter=0`` is the ``record_history=False`` form: one slot,
    which :func:`history_set` leaves as it is."""
    hist = torch.full((maxiter + 1,) + tuple(first_row.shape), math.nan,
                      dtype=torch.float32, device=first_row.device)
    hist[0] = first_row
    return hist


def history_set(hist: torch.Tensor, i: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``hist`` with slot ``i`` (a device index) set to ``row``, out of place.

    A one-slot history (``record_history=False``) comes back as it is, as
    the JAX package drops the out-of-bounds scatter.  Otherwise ``i`` is
    clamped to the last slot on the device, so no host read decides it: in
    a solver loop only a masked step past ``maxiter`` asks for a slot past
    the end, and :func:`while_loop` discards that step's state."""
    if hist.shape[0] == 1:
        return hist
    j = torch.clamp(i, max=hist.shape[0] - 1).reshape(1)
    return hist.index_copy(0, j, row.unsqueeze(0))


def _chunk(cond, body, k, state, active, steps: int):
    """``steps`` masked loop steps with no host read: each applies ``body``
    where ``active`` holds and keeps the old state where it does not."""
    for _ in range(steps):
        new = body(k, state)
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
        k = k + active
        active = cond(state)
    return k, state, active


def while_loop(
    cond: Callable[[tuple], torch.Tensor],
    body: Callable[[torch.Tensor, tuple], tuple],
    state: Tuple[torch.Tensor, ...],
    maxiter: int,
) -> Tuple[torch.Tensor, tuple]:
    """Run ``state = body(k, state)`` while ``k < maxiter`` and
    ``cond(state)`` hold; returns ``(k, state)`` as ``lax.while_loop``
    would.

    ``cond`` returns a device bool (the convergence test), ``body`` the
    new state, out of place (the loop keeps the old state where a step is
    masked), with ``k`` the device step counter.  The host reads the
    flag before the first step and after each chunk of
    :data:`CHECK_EVERY` steps, and launches no more than ``maxiter``
    steps in all (the last chunk is cut short), so ``k`` never passes
    ``maxiter`` and the device test needs no count: a solve of ``n``
    iterations makes about ``n / CHECK_EVERY + 1`` host reads, and no
    chunk syncs.
    """
    k = torch.zeros((), dtype=torch.int64, device=state[0].device)
    active = cond(state)
    steps = 0
    # the one host read of a chunk: whether to launch the next one
    while steps < maxiter and bool(active):
        n = min(CHECK_EVERY, maxiter - steps)
        k, state, active = _chunk(cond, body, k, state, active, n)
        steps += n
    return k, state


def emit_history(solver: str, hist: torch.Tensor) -> None:
    """Stream a residual history into ``repro_torch.obs`` as a per-run series.

    Called by the solvers after their loop returns — never inside it, so
    instrumentation costs no per-iteration host syncs: the history comes
    to the host once.  A no-op when the history holds a single slot
    (``record_history=False``); otherwise one summary instant always lands
    in the flight ring, and the full residual series is streamed only
    while obs is enabled.  Blocked RHS histories record the worst column
    per iteration (the convergence test is on the max).  Each call gets
    its own ``run=N``-labelled series, indexed by iteration.
    """
    from repro_torch import obs

    if hist.shape[0] <= 1:  # record_history=False: nothing to stream
        return
    vals = hist.detach().cpu().numpy()
    if vals.ndim > 1:
        # unfilled iterations are all-NaN rows; silence nanmax's warning
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            vals = np.nanmax(vals.reshape(vals.shape[0], -1), axis=1)
    # the always-on flight ring gets one instant per solve regardless of
    # the obs flag — a post-mortem can show what converged around an anomaly
    n = int(np.sum(~np.isnan(vals)))
    obs.get_flight().record(
        "solver.run",
        solver=solver,
        iters=max(n - 1, 0),
        final_residual=float(vals[n - 1]) if n else None,
    )
    if not obs.enabled():
        return
    runs = obs.counter("solver.runs", solver=solver)
    runs.inc()
    series = obs.series(f"solver.{solver}.residual", run=int(runs.value))
    for i, v in enumerate(vals):
        if math.isnan(v):
            break
        series.append(float(v), index=i)
