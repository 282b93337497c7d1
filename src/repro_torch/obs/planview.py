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
:func:`explain_report` joins the static picture with the *measured*
``attr.*`` bandwidth-attribution counters into the per-matrix "why is
this fast or slow" report ``python -m repro_torch.analysis.report
--explain MATRIX`` renders.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = [
    "partition_quality",
    "register_plan_metrics",
    "plan_metrics_from_snapshot",
    "explain_report",
    "explain",
]

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

# imbalance verdict thresholds on the competitive ratio
_BALANCED_BELOW = 1.15
_MILD_BELOW = 1.5

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


# --- snapshot joins (the explain() data plane) ------------------------------


def plan_metrics_from_snapshot(snapshot: dict, matrix: str) -> dict:
    """Every ``plan.*`` metric for ``matrix`` out of an ``obs.dump()``
    snapshot: plain gauges as ``{short_name: value}``, the per-trial and
    per-contract families as sorted ``(label, value)`` lists under
    ``autotune_trials`` / ``k_tiling_us`` / ``k_tiling_choice``."""
    out: dict = {"autotune_trials": [], "k_tiling_us": [], "k_tiling_choice": []}
    for reg in snapshot.get("registries", []):
        for m in reg.get("metrics", []):
            name = m.get("name", "")
            lab = m.get("labels") or {}
            if lab.get("matrix") != matrix or not name.startswith("plan."):
                continue
            short = name[len("plan.") :]
            if name == "plan.autotune_trial_us":
                out["autotune_trials"].append((lab.get("config", "?"), m["value"]))
            elif name == "plan.k_tiling_us":
                out["k_tiling_us"].append((lab.get("k_tiling", "?"), m["value"]))
            elif name == "plan.k_tiling_choice":
                out["k_tiling_choice"].append(lab.get("k_tiling", "?"))
            elif "value" in m:
                out[short] = m["value"]
    out["autotune_trials"].sort(key=lambda t: (t[1], t[0]))
    out["k_tiling_us"].sort()
    out["k_tiling_choice"].sort()
    return out


def _fmt(v, digits: int = 3) -> str:
    if v is None:
        return "n/a"
    return f"{v:.{digits}f}"


def _verdict(pm: dict) -> List[str]:
    """The imbalance/cohesion verdict lines, n/a-safe."""
    lines = []
    cr = pm.get("competitive_ratio")
    if cr is None:
        lines.append("verdict: n/a — no partition-quality gauges in this dump")
        return lines
    if cr <= _BALANCED_BELOW:
        lines.append(
            f"verdict: balanced (competitive ratio {cr:.3f} <= "
            f"{_BALANCED_BELOW}) — the partition is not the bottleneck"
        )
    elif cr <= _MILD_BELOW:
        lines.append(
            f"verdict: mildly imbalanced (competitive ratio {cr:.3f}) — "
            "placement can still help; watch the dominant row groups"
        )
    else:
        lines.append(
            f"verdict: IMBALANCED (competitive ratio {cr:.3f} > {_MILD_BELOW}) "
            "— a few blocks dominate; no schedule can recover this, "
            "re-partition (smaller row_block / narrower lane) instead"
        )
    score = pm.get("cohesion_score")
    if score is not None:
        if score >= 1.2:
            lines.append(
                f"hash grouping is earning its keep: cohesion {score:.2f}x "
                "the random-grouping baseline"
            )
        elif score <= 1.05:
            lines.append(
                f"hash grouping adds little here (cohesion {score:.2f}x "
                "random) — rows are homogeneous or patterns are scattered"
            )
    return lines


def explain_report(snapshot: dict, matrix: str, *, hw=None) -> str:
    """The per-matrix "why is this fast or slow" report.

    Joins three planes of one ``obs.dump()`` snapshot: the static
    partition-quality gauges, the autotune decision provenance, and the
    measured ``attr.*`` bandwidth attribution vs the modeled roofline of
    ``hw`` (None: the card's spec, which raises without a card), whose
    part the bandwidth lines name.  Every section renders "n/a" on missing
    data (a dump taken before any traffic, or from a registry without plan
    introspection) and all rows are deterministically ordered.
    """
    from repro_torch.analysis.roofline import card_spec

    from .attribution import attribution_rows

    hw = hw or card_spec()
    pm = plan_metrics_from_snapshot(snapshot, matrix)
    lines = [f"== explain: {matrix} =="]

    # --- partition quality -------------------------------------------------
    lines.append("-- partition quality --")
    if pm.get("tiles") is None:
        lines.append(
            "  n/a — no plan.* gauges for this matrix in the dump (admit it "
            "through a MatrixRegistry, then obs.dump() again)"
        )
    else:
        lines.append(
            f"  tiles={int(pm['tiles'])}  rowgroups={int(pm.get('rowgroups', 0))}  "
            f"nnz_utilization={_fmt(pm.get('nnz_utilization'))}"
        )
        lines.append(
            "  tile occupancy: "
            f"p10={_fmt(pm.get('occupancy_p10'))} "
            f"p50={_fmt(pm.get('occupancy_p50'))} "
            f"p90={_fmt(pm.get('occupancy_p90'))} "
            f"(mean {_fmt(pm.get('occupancy_mean'))}, "
            f"min {_fmt(pm.get('occupancy_min'))})"
        )
        lines.append(
            f"  rowgroup imbalance (max/mean cost): "
            f"{_fmt(pm.get('rowgroup_imbalance'))}"
        )
        lines.append(
            f"  competitive ratio (LPT makespan / ideal): "
            f"{_fmt(pm.get('competitive_ratio'))}"
        )
        lines.append(
            f"  hash-group cohesion: {_fmt(pm.get('cohesion'))} "
            f"vs random {_fmt(pm.get('cohesion_random'))} "
            f"(score {_fmt(pm.get('cohesion_score'), 2)}x)"
        )

    # --- autotune provenance ----------------------------------------------
    lines.append("-- autotune provenance --")
    searched = pm.get("autotune_searched")
    if searched is None:
        lines.append("  n/a — no autotune gauges for this matrix")
    else:
        if searched:
            src = "measured search"
        elif pm.get("autotune_cache_hit"):
            src = "on-disk cache hit"
        else:
            src = "heuristic/pinned config"
        evals = int(pm.get("autotune_evaluations") or 0)
        obj = pm.get("autotune_objective_us")
        lines.append(
            f"  decision: {src}, {evals} candidate(s) measured"
            + (f", winner objective {obj:.1f}us" if obj is not None else "")
        )
        trials = pm["autotune_trials"]
        if trials:
            best = trials[0][1]
            for i, (label, us) in enumerate(trials):
                delta = "winner" if i == 0 else f"+{100 * (us / best - 1):.1f}%"
                lines.append(f"    {label:<24} {us:>10.1f}us  {delta}")
        choice = pm["k_tiling_choice"]
        kt_us = dict(pm["k_tiling_us"])
        if kt_us:
            measured = "  ".join(f"{kt}={us:.1f}us" for kt, us in sorted(kt_us.items()))
            lines.append(
                f"  k_tiling: {', '.join(choice) or '?'} (measured: {measured})"
            )
        elif choice:
            lines.append(
                f"  k_tiling: {', '.join(choice)} "
                "(contracts coincide at the served width — no measurement needed)"
            )

    # --- measured traffic vs model ----------------------------------------
    lines.append("-- measured traffic (modeled vs measured bandwidth) --")
    rows = [r for r in attribution_rows(snapshot, hw=hw) if r["matrix"] == matrix]
    if not rows:
        lines.append("  n/a — no attr.* counters for this matrix (serve traffic first)")
    for r in rows:
        ach = r["achieved_gbps"]
        frac = r["roofline_fraction"]
        lines.append(
            f"  strategy={r['strategy']} k_tiling={r['k_tiling']}: "
            f"launches={r['launches']} "
            f"modeled={1e3 * r['modeled_s']:.3f}ms measured={1e3 * r['measured_s']:.3f}ms "
            f"achieved={'n/a' if ach is None else f'{ach:.3f}'} GB/s"
            + (
                ""
                if frac is None
                else f" = {100 * frac:.1f}% of {hw.name} HBM"
            )
            + ("  [BELOW-ROOFLINE]" if r["below_roofline"] else "")
        )

    # --- verdict -----------------------------------------------------------
    lines.extend(_verdict(pm))
    return "\n".join(lines) + "\n"


def explain(matrix: str, snapshot: Optional[dict] = None, *, hw=None) -> str:
    """Live convenience: explain ``matrix`` from the current process state
    (or a provided ``obs.dump()`` snapshot)."""
    if snapshot is None:
        from repro_torch import obs

        snapshot = obs.collect()
    return explain_report(snapshot, matrix, hw=hw)
