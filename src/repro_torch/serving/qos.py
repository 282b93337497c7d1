"""Quality of service for multi-tenant SpMV serving.

One device, many tenants: every matrix resident in a
:class:`~repro.serving.registry.MatrixRegistry` is a tenant competing for
the same kernel-launch budget.  This module is the policy layer the
:class:`~repro.serving.engine.ServingEngine` consults on every submit and
every poll:

* :class:`QoSClass` — a named deadline class (per-request deadline,
  weighted-fair share, admission-control queue depth).  Deadline classes
  map directly onto the engine's per-matrix SLO accounting: the class
  deadline is what ``deadline_hit`` means for that tenant's requests, so
  the existing ``deadline_hit_ratio`` objectives and ``slo.*`` burn-rate
  gauges evaluate each tenant against its own class.
* :class:`BackpressureError` — the typed rejection admission control
  raises when a tenant's queue is saturated.  Shedding is never silent: a
  request is either enqueued (and will complete) or the caller gets this
  error with the depth/limit evidence and may retry or downgrade.
* :class:`WeightedFairScheduler` — the flush-order policy.  Tenants
  accumulate virtual work (served columns divided by their class weight),
  and due tenants are flushed lowest-virtual-work first, so a weight-4
  tenant sustains 4x the service share of a weight-1 tenant under
  contention.  Tenants whose SLO is paging are boosted ahead of the fair
  order (burn rates are the scheduler input, not just a dashboard), and
  head-of-line queue wait breaks ties so a starving queue cannot be
  shadowed by an equally-charged one.

Everything here is pure policy — no kernels, no clocks of its own — so
the scheduler is exactly testable the way the micro-batcher is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional

__all__ = [
    "QoSClass",
    "BackpressureError",
    "WeightedFairScheduler",
    "BEST_EFFORT",
    "STANDARD",
    "GOLD",
]

# severity order the scheduler boosts by: paging tenants flush first
_STATUS_RANK = {"page": 0, "warn": 1, "ok": 2}


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One deadline class: the service contract a tenant's requests get.

    ``deadline_s`` is the per-request latency deadline — a completed
    request is a deadline hit iff it waited at most this long, which is
    exactly the event the engine's ``deadline_hit_ratio`` SLOs and burn
    rates evaluate.  ``weight`` is the tenant's weighted-fair share of
    flush order under contention (relative to other tenants' weights).
    ``max_queue`` is the admission-control depth: a submit that finds the
    tenant's queue already holding this many requests is rejected with a
    :class:`BackpressureError` (``None`` disables shedding — the queue
    may grow without bound, as the pre-QoS engine allowed).
    ``max_wait_s`` optionally overrides the engine's batching window for
    this class: a tight-deadline class flushes its batches earlier.
    """

    name: str
    deadline_s: float
    weight: float = 1.0
    max_queue: Optional[int] = None
    max_wait_s: Optional[float] = None

    def __post_init__(self):
        """Validate the class invariants (positive deadline and weight)."""
        if self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_wait_s is not None and self.max_wait_s <= 0:
            raise ValueError(f"max_wait_s must be > 0, got {self.max_wait_s}")


# ready-made classes for the common three-tier setup; engines default to a
# per-engine "standard" class whose deadline is the batching window
GOLD = QoSClass("gold", deadline_s=0.005, weight=4.0, max_queue=None)
STANDARD = QoSClass("standard", deadline_s=0.02, weight=1.0, max_queue=None)
BEST_EFFORT = QoSClass(
    "best_effort", deadline_s=0.1, weight=0.25, max_queue=64
)


class BackpressureError(RuntimeError):
    """Typed admission-control rejection: the tenant's queue is saturated.

    Raised by :meth:`~repro.serving.engine.ServingEngine.submit` *before*
    the request is enqueued, so a shed request holds no queue slot and no
    ticket — the caller owns the retry/downgrade decision.  Carries the
    evidence: ``key`` (the tenant), ``qos`` (its class name), ``depth``
    (queue depth observed) and ``limit`` (the class ``max_queue``).
    """

    def __init__(self, key: str, qos: str, depth: int, limit: int):
        """Record the shed evidence and compose the message."""
        super().__init__(
            f"queue for {key!r} is saturated ({depth} >= max_queue={limit} "
            f"of QoS class {qos!r}); request shed — retry later or submit "
            "under a higher class"
        )
        self.key = key
        self.qos = qos
        self.depth = depth
        self.limit = limit


class WeightedFairScheduler:
    """Weighted-fair flush ordering over due tenants.

    Each tenant accumulates **virtual work**: served columns divided by
    its class weight (:meth:`charge`).  :meth:`order` sorts due tenants by
    (SLO status, virtual work, head-of-line wait, key) — paging tenants
    first, then least-served-relative-to-weight, oldest head request
    breaking ties, key last so the order is fully deterministic.

    A tenant first seen mid-run joins at the *minimum* live virtual work
    rather than zero, so a late joiner gets fair service from now on but
    no retroactive credit that would starve incumbents.
    """

    def __init__(self, weight_of: Callable[[str], float]):
        """Build a scheduler that reads per-key weights via ``weight_of``."""
        self.weight_of = weight_of
        self._vwork: Dict[str, float] = {}

    def vwork(self, key: str) -> float:
        """Virtual work accumulated by ``key`` (joins at the live minimum)."""
        v = self._vwork.get(key)
        if v is None:
            v = min(self._vwork.values(), default=0.0)
            self._vwork[key] = v
        return v

    def charge(self, key: str, columns: int) -> float:
        """Account one served batch of ``columns`` columns against ``key``.

        Returns the tenant's updated virtual work (columns / weight are
        the units — a weight-4 tenant is charged a quarter per column).
        """
        v = self.vwork(key) + columns / self.weight_of(key)
        self._vwork[key] = v
        return v

    def order(
        self,
        keys: Iterable[str],
        *,
        head_wait: Optional[Callable[[str], float]] = None,
        status: Optional[Mapping[str, str]] = None,
    ) -> List[str]:
        """Flush order for the due ``keys`` (see class docstring).

        ``head_wait`` maps a key to its oldest pending request's wait (a
        :class:`~repro.obs.requesttrace.RequestContext` submit stamp
        against now); ``status`` maps a key to its latest SLO
        classification (``ok``/``warn``/``page``) — both optional, both
        read-only inputs.
        """
        status = status or {}

        def rank(key: str):
            return (
                _STATUS_RANK.get(status.get(key, "ok"), 2),
                self.vwork(key),
                -(head_wait(key) if head_wait is not None else 0.0),
                key,
            )

        return sorted(keys, key=rank)

    def snapshot(self) -> Dict[str, float]:
        """Current per-key virtual work (for stats views and tests)."""
        return dict(self._vwork)
