"""Micro-batching of concurrent SpMV requests into ``[n, k]`` SpMM blocks.

The HBP format's dominant per-multiply cost is streaming the tile arrays
from HBM; the SpMM kernel reads that stream once for all ``k`` RHS columns
(bench_solvers measures ~5x at k=8).  Serving traffic realises the same
win by coalescing: requests against the same matrix that arrive within a
small window are stacked column-wise and served by one kernel launch.

:class:`MicroBatcher` is the pure queueing policy — no kernels, no clocks
of its own, so it is exactly testable:

* one FIFO per matrix key (requests never migrate across matrices);
* a batch closes when it reaches ``max_batch`` columns (k-bucket ceiling)
  or when its oldest request has waited ``max_wait_s`` (deadline flush:
  bounded worst-case queueing latency under thin traffic);
* drained batches are stacked into ``[n, k]`` blocks whose k the engine
  pads to the serving buckets (:data:`repro.kernels.ops.K_BUCKETS`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["SpMVRequest", "MicroBatcher"]


@dataclasses.dataclass
class SpMVRequest:
    """One ``y = A @ x`` request as tracked by the batcher/engine."""

    key: str  # registry plan name
    x: np.ndarray  # f32[n_cols]
    req_id: int
    t_submit: float
    t_done: Optional[float] = None
    result: Optional[np.ndarray] = None
    # the request-scoped trace context (repro.obs.requesttrace.RequestContext);
    # typed loosely so the pure queueing module stays obs-import-free
    ctx: Optional[object] = None

    @property
    def done(self) -> bool:
        """Whether the request has completed (its result is assigned)."""
        return self.result is not None


class MicroBatcher:
    """Per-matrix FIFO queues with size- and deadline-triggered flushes.

    ``max_wait_s`` is the default batching window; :meth:`set_wait`
    overrides it per key so a tight-deadline QoS class flushes its
    batches earlier than the engine-wide default.
    """

    def __init__(self, *, max_batch: int = 16, max_wait_s: float = 0.002):
        """Create empty queues with the given size/deadline flush policy."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._queues: Dict[str, Deque[SpMVRequest]] = {}
        self._waits: Dict[str, float] = {}

    def add(self, req: SpMVRequest) -> None:
        """Enqueue one request on its matrix's FIFO."""
        self._queues.setdefault(req.key, deque()).append(req)

    def pending(self, key: Optional[str] = None) -> int:
        """Pending request count for ``key`` (or across all queues)."""
        if key is not None:
            return len(self._queues.get(key, ()))
        return sum(len(q) for q in self._queues.values())

    def set_wait(self, key: str, max_wait_s: Optional[float]) -> None:
        """Override ``key``'s batching window; ``None`` restores default."""
        if max_wait_s is None:
            self._waits.pop(key, None)
        else:
            self._waits[key] = max_wait_s

    def wait_for(self, key: str) -> float:
        """The batching window in effect for ``key``."""
        return self._waits.get(key, self.max_wait_s)

    def head_age(self, key: str, now: float) -> float:
        """Wait of ``key``'s oldest pending request, 0 on an empty queue."""
        q = self._queues.get(key)
        if not q:
            return 0.0
        return now - q[0].t_submit

    def due(self, now: float) -> List[str]:
        """Keys whose head batch must flush now: full, or deadline hit."""
        out = []
        for key, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self.max_batch or now - q[0].t_submit >= self.wait_for(key):
                out.append(key)
        return out

    def take(self, key: str) -> List[SpMVRequest]:
        """Pop the next batch (up to ``max_batch`` oldest requests) for key."""
        q = self._queues.get(key)
        if not q:
            return []
        return [q.popleft() for _ in range(min(len(q), self.max_batch))]

    def keys_with_pending(self) -> List[str]:
        """Keys that currently hold at least one queued request."""
        return [k for k, q in self._queues.items() if q]

    @staticmethod
    def stack(batch: List[SpMVRequest]) -> np.ndarray:
        """Column-stack a batch into the ``[n, k]`` RHS block of one SpMM."""
        return np.stack([np.asarray(r.x, np.float32) for r in batch], axis=1)
