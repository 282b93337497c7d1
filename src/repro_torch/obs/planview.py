"""Plan introspection: the partition-quality metrics of one admitted plan.

Computed once per admission from quantities the tile build already
produced, and published as always-live labelled gauges on the serving
registry's shared :class:`~repro_torch.obs.metrics.MetricRegistry`:

* **per-tile occupancy** — each tile streams ``group × lane`` slots from
  device memory whether useful or not; its nnz / slots ratio is the exact
  fraction of that traffic that was not padding;
* **row-group cost distribution** — tiles per output row group; its
  ``max/mean`` imbalance is what a skewed matrix blows up.  On the GPU
  kernels one thread walks a whole row-group run, so this ratio is also
  the longest thread's share of the work;
* **hash-group cohesion** — within-group row-pattern similarity against
  a seeded random within-row-block grouping baseline: the measured value
  of the hash reordering;
* **competitive ratio** — the LPT replay of the paper's competitive
  allocation over per-block tile costs.

Autotune decision provenance (which candidates were measured, what each
cost, how ``k_tiling`` was picked) is published beside it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["partition_quality", "register_plan_metrics"]

# quality keys that become always-live ``plan.<key>`` gauges per matrix
_GAUGE_KEYS = (
    "tiles",
    "nnz_utilization",
    "occupancy_mean",
    "occupancy_min",
    "occupancy_p10",
    "occupancy_p50",
    "occupancy_p90",
    "rowgroups",
    "rowgroup_imbalance",
    "competitive_ratio",
    "cohesion",
    "cohesion_random",
    "cohesion_score",
)

# bounded sample fed to the plan.tile_occupancy histogram: enough for
# stable percentiles, cheap enough for the per-admission budget
_OCCUPANCY_SAMPLE = 256

# at most this many autotune trials become labelled gauges (trials arrive
# sorted fastest-first, so the winner and its nearest rivals always land;
# the full list still lives in the plan provenance / cache entry)
_MAX_TRIAL_GAUGES = 8


def _pooled_cohesion(footprint, rows, gids, n_groups, nbc) -> Optional[float]:
    """Pooled within-group column-footprint cohesion of one grouping.

    ``footprint`` is the boolean [n_rows, n_col_blocks] row-pattern matrix
    (row r touches column block j); ``rows``/``gids`` are the surviving
    (non-padded, non-empty) member rows and their group ids.  Per group:
    ``touches / (union_blocks * member_rows)`` — exactly 1.0 when every
    member row touches the identical block set, approaching 1/members when
    each row touches its own disjoint blocks.  Groups are pooled weighted
    by membership; ``None`` when nothing touches anything.
    """
    if rows.size == 0:
        return None
    # scatter-add via one flat bincount over the nonzero footprint entries
    # (np.add.at is an order of magnitude slower at admission scale)
    ii, jj = np.nonzero(footprint[rows])
    touch = np.bincount(
        gids[ii] * nbc + jj, minlength=n_groups * nbc
    ).reshape(n_groups, nbc)
    union = (touch > 0).sum(axis=1)
    members = np.bincount(gids, minlength=n_groups)
    live = union > 0
    denom = float((union[live] * members[live]).sum())
    return float(touch[live].sum() / denom) if denom > 0 else None


def partition_quality(
    tiles,
    csr=None,
    *,
    n_workers: int = 2,
    seed: int = 0,
) -> dict:
    """Static quality metrics of one built plan (see module docstring).

    ``tiles`` is the plan's :class:`~repro.core.tile.HBPTiles`; ``csr``
    (the admitted matrix) unlocks the cohesion scores — without it they
    are ``None``.  ``n_workers`` sizes the LPT competitive-ratio model
    (default 2: the megacore slots of one chip); ``seed`` fixes the
    random-grouping cohesion baseline so the gauges are deterministic.
    Everything is vectorised numpy over arrays the tile build already
    holds — cheap enough to run on every admission (``bench_obs`` pins
    the budget).
    """
    from repro_torch.core.schedule import lpt_schedule

    occ = tiles.tile_occupancy()
    rg = tiles.rowgroup_costs().astype(np.float64)
    block = tiles.block_costs().astype(np.float64)

    out: dict = {
        "tiles": float(tiles.n_tiles),
        "nnz_utilization": tiles.nnz_utilization(),
        "rowgroups": float(tiles.n_rowgroups),
        "schedule_workers": float(n_workers),
    }
    if occ.size:
        p10, p50, p90 = np.percentile(occ, (10, 50, 90))
        out.update(
            occupancy_mean=float(occ.mean()),
            occupancy_min=float(occ.min()),
            occupancy_p10=float(p10),
            occupancy_p50=float(p50),
            occupancy_p90=float(p90),
        )
    else:
        out.update(
            occupancy_mean=None,
            occupancy_min=None,
            occupancy_p10=None,
            occupancy_p50=None,
            occupancy_p90=None,
        )
    out["rowgroup_imbalance"] = (
        float(rg.max() / rg.mean()) if rg.size and rg.mean() > 0 else 1.0
    )
    if block.sum() > 0:
        sched = lpt_schedule(block, n_workers)
        out["competitive_ratio"] = sched.competitive_ratio
    else:
        out["competitive_ratio"] = 1.0

    cohesion = cohesion_random = score = None
    if csr is not None and csr.nnz:
        from repro_torch.core.partition import count_block_nnz

        footprint = count_block_nnz(csr, tiles.cfg) > 0
        n_rows = csr.shape[0]
        G, R = tiles.cfg.group, tiles.cfg.row_block
        cohesion = _grouping_cohesion(footprint, tiles.perm, G, n_rows)
        # baseline: the same rows grouped at random WITHIN each row block
        # (the hash only ever permutes inside a block, so that is the
        # fair counterfactual)
        rng = np.random.default_rng(seed)
        rand_perm = np.empty_like(tiles.perm)
        for bi in range(tiles.perm.size // R):
            rand_perm[bi * R : (bi + 1) * R] = rng.permutation(R) + bi * R
        cohesion_random = _grouping_cohesion(footprint, rand_perm, G, n_rows)
        if cohesion is not None and cohesion_random:
            score = cohesion / cohesion_random
    out.update(
        cohesion=cohesion, cohesion_random=cohesion_random, cohesion_score=score
    )
    out["occupancy_sample"] = occ[
        :: max(1, occ.size // _OCCUPANCY_SAMPLE)
    ].tolist()
    return out


def _grouping_cohesion(footprint, perm, group, n_rows) -> Optional[float]:
    """Cohesion of the grouping ``perm`` induces (see :func:`_pooled_cohesion`)."""
    n_pos = perm.size
    gids_all = np.arange(n_pos) // group
    valid = perm < n_rows
    rows = perm[valid]
    gids = gids_all[valid]
    nonempty = footprint[rows].any(axis=1)
    return _pooled_cohesion(
        footprint, rows[nonempty], gids[nonempty], n_pos // group, footprint.shape[1]
    )


def register_plan_metrics(
    metrics, name: str, quality: dict, provenance: Optional[dict] = None
) -> None:
    """Publish one plan's quality + provenance as always-live metrics.

    ``metrics`` is the serving registry's shared
    :class:`~repro.obs.metrics.MetricRegistry`; gauges are labelled
    ``matrix=name`` so they join the ``attr.*`` / ``serving.*`` families
    in dumps and OpenMetrics scrapes.  Numeric quality keys become
    ``plan.<key>`` gauges; the bounded occupancy sample feeds the
    ``plan.tile_occupancy`` histogram; autotune provenance lands as
    ``plan.autotune_*`` gauges (per-trial objective times labelled by the
    candidate geometry) plus ``plan.k_tiling_us`` per measured contract.
    """
    for key in _GAUGE_KEYS:
        v = quality.get(key)
        if v is not None:
            metrics.gauge(f"plan.{key}", matrix=name).set(float(v))
    sample = quality.get("occupancy_sample") or ()
    if sample:
        h = metrics.histogram(
            "plan.tile_occupancy",
            buckets=[round(0.1 * i, 1) for i in range(1, 11)],
            window=_OCCUPANCY_SAMPLE,
            matrix=name,
        )
        for v in sample:
            h.observe(float(v))
    if not provenance:
        return
    m = metrics
    m.gauge("plan.autotune_searched", matrix=name).set(
        1.0 if provenance.get("searched") else 0.0
    )
    m.gauge("plan.autotune_cache_hit", matrix=name).set(
        1.0 if provenance.get("cache_hit") else 0.0
    )
    m.gauge("plan.autotune_evaluations", matrix=name).set(
        float(provenance.get("evaluations") or 0)
    )
    if provenance.get("objective_us") is not None:
        m.gauge("plan.autotune_objective_us", matrix=name).set(
            float(provenance["objective_us"])
        )
    for trial in list(provenance.get("trials") or ())[:_MAX_TRIAL_GAUGES]:
        cfg = trial.get("config") or {}
        label = _config_label(cfg)
        m.gauge("plan.autotune_trial_us", matrix=name, config=label).set(
            float(trial["objective_us"])
        )
    for kt, us in sorted((provenance.get("k_tiling_us") or {}).items()):
        m.gauge("plan.k_tiling_us", matrix=name, k_tiling=kt).set(float(us))
    kt = provenance.get("k_tiling")
    if kt:
        m.gauge("plan.k_tiling_choice", matrix=name, k_tiling=kt).set(1.0)


def _config_label(cfg: dict) -> str:
    return (
        f"r{cfg.get('row_block', '?')}.c{cfg.get('col_block', '?')}"
        f".g{cfg.get('group', '?')}.l{cfg.get('lane', '?')}"
    )
