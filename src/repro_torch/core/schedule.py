"""Mixed execution allocation (paper §III-C), adapted to TPU scheduling.

The paper balances load *between* matrix blocks by splitting the block set
into a **fixed part** — statically assigned, one warp per block, preferring
same-column blocks per warp so the shared-memory vector segment is reused —
and a **competitive part** — blocks grabbed at runtime (ticket lock) by
warps that finished their fixed quota ("those who are capable work harder").

TPU adaptation (DESIGN.md §Hardware-adaptation): a TPU program is statically
scheduled — there is no runtime work stealing between cores.  But the
*reason* the GPU needs runtime competition is that execution time is
unpredictable (cache misses, divergence).  On TPU, per-block execution time
is a deterministic function of the tile count, so the competitive phase can
be *played out at schedule time*: we simulate "whoever is free takes the
next block", which is exactly the greedy LPT (longest-processing-time)
policy.  The fixed/competitive split therefore becomes:

* fixed part      — ``fixed_fraction`` of total work assigned round-robin in
  column-major order (locality: consecutive blocks of a worker share the
  same x segment, the VMEM analogue of the paper's shared-memory reuse);
* competitive part — the remaining blocks, sorted by descending cost, each
  assigned to the currently least-loaded worker (deterministic ticket-lock
  replay).

Workers are devices (distributed SpMV) or the two megacore slots of one
chip.  The returned schedule is dense: per-worker block lists padded to
equal length with null blocks, so every worker runs the same program.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np

__all__ = ["Schedule", "mixed_schedule", "lpt_schedule", "contiguous_schedule"]


@dataclasses.dataclass
class Schedule:
    """Assignment of blocks to workers.

    ``assignment[w]`` lists block ids for worker ``w`` in execution order;
    ``loads[w]`` is the summed cost.  ``makespan_ratio`` = max load / mean
    load: 1.0 is a perfect balance (the metric of the Fig. 5 discussion).
    """

    assignment: List[List[int]]
    loads: np.ndarray
    fixed_counts: np.ndarray  # how many of each worker's blocks were fixed

    @property
    def makespan_ratio(self) -> float:
        mean = self.loads.mean()
        return float(self.loads.max() / mean) if mean > 0 else 1.0

    @property
    def competitive_ratio(self) -> float:
        """Modeled makespan over the ideal balanced makespan.

        ``ideal = total / n_workers`` (every worker slot counted, loaded or
        not), so this equals :attr:`makespan_ratio` but carries the paper's
        framing: how far the competitive allocation lands from a perfectly
        balanced split.  1.0 is ideal; a value pinned well above 1 means a
        single block dominates and NO schedule can balance the work — the
        partition itself is the bottleneck, not the placement.
        """
        return self.makespan_ratio

    def padded(self, null_block: int = -1) -> np.ndarray:
        """Dense [workers, max_len] block-id matrix padded with null blocks."""
        n = max((len(a) for a in self.assignment), default=0)
        out = np.full((len(self.assignment), n), null_block, dtype=np.int64)
        for w, blocks in enumerate(self.assignment):
            out[w, : len(blocks)] = blocks
        return out


def contiguous_schedule(costs: np.ndarray, n_workers: int) -> Schedule:
    """Naive static split: equal *count* of blocks per worker (the baseline
    the paper's fixed/competitive split improves on)."""
    n = costs.size
    ids = np.arange(n)
    chunks = np.array_split(ids, n_workers)
    loads = np.array([costs[c].sum() for c in chunks], dtype=np.float64)
    return Schedule([list(c) for c in chunks], loads, np.array([len(c) for c in chunks]))


def lpt_schedule(costs: np.ndarray, n_workers: int) -> Schedule:
    """Pure greedy LPT: every block competitive (no locality)."""
    order = np.argsort(-costs, kind="stable")
    heap = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    assignment: List[List[int]] = [[] for _ in range(n_workers)]
    for b in order:
        load, w = heapq.heappop(heap)
        assignment[w].append(int(b))
        heapq.heappush(heap, (load + float(costs[b]), w))
    loads = np.array([costs[a].sum() if a else 0.0 for a in assignment])
    return Schedule(assignment, loads, np.zeros(n_workers, dtype=np.int64))


def mixed_schedule(
    costs: np.ndarray,
    n_workers: int,
    *,
    n_cols: int | None = None,
    fixed_fraction: float = 0.7,
) -> Schedule:
    """The paper's fixed + competitive allocation, replayed statically.

    ``costs`` is per-block work (tile count / nnz), flattened row-major over
    the (row-block, col-block) grid; ``n_cols`` is the number of column
    blocks — needed to group same-column blocks in the fixed phase.
    """
    from repro_torch import obs

    with obs.span(
        "admit.schedule", blocks=int(costs.size), workers=n_workers
    ) as sp:
        sched = _mixed_schedule_impl(
            costs, n_workers, n_cols=n_cols, fixed_fraction=fixed_fraction
        )
        sp.annotate(makespan_ratio=round(sched.makespan_ratio, 4))
    if obs.enabled():
        obs.gauge("schedule.makespan_ratio").set(sched.makespan_ratio)
        obs.counter("schedule.builds").inc()
    return sched


def _mixed_schedule_impl(
    costs: np.ndarray,
    n_workers: int,
    *,
    n_cols: int | None = None,
    fixed_fraction: float = 0.7,
) -> Schedule:
    n = costs.size
    ids = np.arange(n)
    if n_cols:
        # column-major visit order: same-column blocks land on the same
        # worker consecutively (vector-segment reuse).
        cols = ids % n_cols
        visit = ids[np.argsort(cols, kind="stable")]
    else:
        visit = ids
    total = float(costs.sum())
    fixed_budget = fixed_fraction * total

    assignment: List[List[int]] = [[] for _ in range(n_workers)]
    loads = np.zeros(n_workers, dtype=np.float64)
    fixed_counts = np.zeros(n_workers, dtype=np.int64)

    # --- fixed part: round-robin contiguous runs of the column-major order
    assigned = np.zeros(n, dtype=bool)
    spent = 0.0
    w = 0
    per_worker_quota = fixed_budget / n_workers if n_workers else 0.0
    for b in visit:
        if spent >= fixed_budget:
            break
        if loads[w] >= (fixed_counts[w] + 1) * 0 + per_worker_quota and w < n_workers - 1:
            w += 1
        assignment[w].append(int(b))
        loads[w] += float(costs[b])
        fixed_counts[w] += 1
        assigned[b] = True
        spent += float(costs[b])

    # --- competitive part: deterministic ticket-lock replay == greedy LPT
    rest = ids[~assigned]
    order = rest[np.argsort(-costs[rest], kind="stable")]
    heap = [(loads[ww], ww) for ww in range(n_workers)]
    heapq.heapify(heap)
    for b in order:
        load, ww = heapq.heappop(heap)
        assignment[ww].append(int(b))
        load += float(costs[b])
        loads[ww] = load
        heapq.heappush(heap, (load, ww))

    return Schedule(assignment, loads, fixed_counts)
