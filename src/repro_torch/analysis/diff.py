"""Differential performance attribution between two observability artifacts.

    PYTHONPATH=src python -m repro_torch.analysis.diff A.json B.json [--out DIFF.md]

Both arguments must be the *same kind* of artifact, either:

* two ``repro_torch.obs.dump()`` snapshots — the diff decomposes the change
  per phase (``admit.*`` vs ``kernels.*`` vs ``serve.*``), per span name,
  per request-log aggregate (queue wait vs compute share), and per
  ``attr.*`` (matrix, strategy, k_tiling) attribution counter; or
* two ``benchmarks.run --json`` artifacts — the diff is per bench record
  (gate metric: ``min_us``, falling back to ``median_us``) with the same
  phase rollup over the ``suite/name`` prefixes.

The output is a **ranked culprit table**: time-like rows ordered by the
absolute time they added (``excess``), so "what regressed" is the first
line, not a needle in a wall of ratios.  Counter rows (launches, bytes)
never carry time units and rank below every timed row — they explain a
culprit, they are not one.  ``--out`` writes the same table as markdown,
an artifact that names the regressed phase without a local rerun.

Everything is n/a-safe (missing sections diff to empty, zero baselines
report ``new``) and deterministically ordered.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "load_artifact",
    "artifact_kind",
    "diff_artifacts",
    "diff_bench_records",
    "diff_obs",
    "render_text",
    "render_markdown",
    "main",
]


def load_artifact(path) -> dict:
    return json.loads(Path(path).read_text())


def artifact_kind(payload: dict) -> str:
    """``"bench"`` (benchmarks.run --json) or ``"obs"`` (obs.dump())."""
    if isinstance(payload, dict) and "benches" in payload:
        return "bench"
    if isinstance(payload, dict) and "registries" in payload:
        return "obs"
    raise ValueError(
        "unrecognized artifact: expected a benchmarks.run --json payload "
        '(has "benches") or a repro_torch.obs.dump() snapshot (has "registries")'
    )


def _phase(name: str) -> str:
    """Phase prefix of a row name: ``admit.schedule`` -> ``admit``,
    ``preprocess/hash_group`` -> ``preprocess``."""
    for sep in ("/", "."):
        if sep in name:
            return name.split(sep, 1)[0]
    return name


def _row(name: str, a, b, unit: str, *, timed: bool) -> dict:
    """One comparison row; ``excess`` (time added, in ``unit``) only for
    timed rows — counters explain culprits, they never rank as one."""
    ratio = (b / a) if a else None
    return {
        "name": name,
        "phase": _phase(name),
        "a": a,
        "b": b,
        "unit": unit,
        "ratio": ratio,
        "excess": (b - a) if timed else None,
    }


def _rank(rows: List[dict]) -> List[dict]:
    """Ranked culprit order: timed rows by time added desc, then counters
    by ratio desc; name breaks every tie (deterministic output)."""
    return sorted(
        rows,
        key=lambda r: (
            r["excess"] is None,
            -(r["excess"] or 0.0),
            -(r["ratio"] or 0.0),
            r["name"],
        ),
    )


# --- bench artifacts ---------------------------------------------------------


def _bench_records(payload: dict) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for rec in payload.get("benches", []):
        out[rec["name"]] = rec
    return out


def diff_bench_records(a: Dict[str, dict], b: Dict[str, dict]) -> List[dict]:
    """Per-record rows over two ``{name: record}`` maps (the shape
    ``benchmarks.compare.load_records`` produces)."""
    rows = []
    for name in sorted(set(a) & set(b)):
        ra, rb = a[name], b[name]
        metric = "min_us" if ("min_us" in ra and "min_us" in rb) else "median_us"
        va, vb = ra.get(metric), rb.get(metric)
        if va is None or vb is None:
            continue
        rows.append(_row(name, float(va), float(vb), "us", timed=True))
    return rows


# --- obs snapshots -----------------------------------------------------------


def _span_rows(a: dict, b: dict) -> List[dict]:
    sa = {s["name"]: s for s in a.get("spans") or []}
    sb = {s["name"]: s for s in b.get("spans") or []}
    return [
        _row(
            name,
            float(sa[name].get("total_ms") or 0.0),
            float(sb[name].get("total_ms") or 0.0),
            "ms",
            timed=True,
        )
        for name in sorted(set(sa) & set(sb))
    ]


def _request_rows(a: dict, b: dict) -> List[dict]:
    """Queue-wait vs compute decomposition of the request logs: mean
    seconds per completed request, as ms rows under phase ``requests``."""

    def agg(snapshot) -> Dict[str, float]:
        reqs = snapshot.get("requests") or []
        out = {}
        for field in ("queue_wait_s", "compute_share_s", "latency_s"):
            vals = [r[field] for r in reqs if r.get(field) is not None]
            if vals:
                out[field] = 1e3 * sum(vals) / len(vals)
        return out

    ra, rb = agg(a), agg(b)
    return [
        _row(f"requests.{f[: -2]}_mean", ra[f], rb[f], "ms", timed=True)
        for f in sorted(set(ra) & set(rb))
    ]


def _counter_values(snapshot: dict) -> Dict[str, float]:
    """Every counter in every registry, keyed ``name{k=v,...}`` (labels
    sorted) and summed across registries (live dumps can hold one family
    in several registries)."""
    out: Dict[str, float] = {}
    for reg in snapshot.get("registries") or []:
        for m in reg.get("metrics") or []:
            if m.get("type") != "counter" or "value" not in m:
                continue
            labels = m.get("labels") or {}
            tag = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
            key = f"{m['name']}{{{tag}}}" if tag else m["name"]
            out[key] = out.get(key, 0.0) + float(m["value"])
    return out


def _counter_rows(a: dict, b: dict) -> List[dict]:
    ca, cb = _counter_values(a), _counter_values(b)
    rows = []
    for key in sorted(set(ca) & set(cb)):
        base = key.split("{", 1)[0]
        if base.endswith("_s"):
            # seconds-valued counters (attr.compute_s, attr.modeled_s,
            # registry.preprocess_s ...) are time — they rank as culprits
            rows.append(_row(key, 1e3 * ca[key], 1e3 * cb[key], "ms", timed=True))
        else:
            rows.append(_row(key, ca[key], cb[key], "", timed=False))
    return rows


def diff_obs(a: dict, b: dict) -> List[dict]:
    return _span_rows(a, b) + _request_rows(a, b) + _counter_rows(a, b)


# --- the joined result -------------------------------------------------------


def _phase_table(rows: List[dict]) -> List[dict]:
    """Per-phase rollup of the *timed* rows (total time per phase side)."""
    agg: Dict[str, List[float]] = {}
    for r in rows:
        if r["excess"] is None:
            continue
        pa, pb = agg.setdefault(r["phase"], [0.0, 0.0])
        agg[r["phase"]] = [pa + r["a"], pb + r["b"]]
    out = []
    for phase in sorted(agg):
        pa, pb = agg[phase]
        out.append(
            {
                "phase": phase,
                "a": pa,
                "b": pb,
                "ratio": (pb / pa) if pa else None,
                "excess": pb - pa,
            }
        )
    out.sort(key=lambda r: (-(r["excess"] or 0.0), r["phase"]))
    return out


def diff_artifacts(a: dict, b: dict) -> dict:
    """Compare two same-kind artifacts; see the module docstring.

    Returns ``{"kind", "unit", "rows", "phases", "culprit"}`` with rows in
    ranked culprit order and ``culprit`` the worst *regressed* timed row
    (``None`` when nothing got slower).
    """
    ka, kb = artifact_kind(a), artifact_kind(b)
    if ka != kb:
        raise ValueError(f"cannot diff a {ka} artifact against a {kb} artifact")
    rows = (
        diff_bench_records(_bench_records(a), _bench_records(b))
        if ka == "bench"
        else diff_obs(a, b)
    )
    rows = _rank(rows)
    culprit = next(
        (r for r in rows if r["excess"] is not None and r["excess"] > 0 and r["a"]),
        None,
    )
    return {
        "kind": ka,
        "unit": "us" if ka == "bench" else "ms",
        "rows": rows,
        "phases": _phase_table(rows),
        "culprit": culprit,
    }


# --- rendering ---------------------------------------------------------------


def _fmt_ratio(r: Optional[float]) -> str:
    return "new" if r is None else f"{r:.2f}x"


def _verdict_line(result: dict) -> str:
    c = result["culprit"]
    if c is None:
        return "verdict: no timed row regressed (B <= A everywhere measured)"
    return (
        f"verdict: worst regression is {c['name']} (phase {c['phase']}): "
        f"{c['a']:.1f}{c['unit']} -> {c['b']:.1f}{c['unit']} "
        f"({_fmt_ratio(c['ratio'])}, +{c['excess']:.1f}{c['unit']})"
    )


def render_text(result: dict, *, top: int = 20) -> str:
    lines = [f"== diff ({result['kind']} artifacts) ==", _verdict_line(result)]
    if result["phases"]:
        lines.append("-- per-phase (timed rows, total) --")
        for p in result["phases"]:
            lines.append(
                f"  {p['phase']:<12} {p['a']:>12.1f} -> {p['b']:>12.1f} "
                f"{result['unit']}  ({_fmt_ratio(p['ratio'])})"
            )
    shown = result["rows"][:top]
    if shown:
        lines.append(f"-- ranked culprits (top {len(shown)} of {len(result['rows'])}) --")
        for i, r in enumerate(shown, 1):
            unit = r["unit"]
            excess = "" if r["excess"] is None else f"  +{r['excess']:.1f}{unit}"
            lines.append(
                f"  {i:>3}. {r['name']:<44} {r['a']:.1f}{unit} -> "
                f"{r['b']:.1f}{unit} ({_fmt_ratio(r['ratio'])}){excess}"
            )
    else:
        lines.append("  n/a — no comparable rows shared by the two artifacts")
    return "\n".join(lines) + "\n"


def render_markdown(result: dict, *, top: int = 20, title: str = "Performance diff") -> str:
    lines = [f"# {title}", "", _verdict_line(result), ""]
    if result["phases"]:
        lines += [
            f"## Per-phase ({result['unit']}, timed rows)",
            "",
            "| phase | A | B | ratio |",
            "|---|---|---|---|",
        ]
        for p in result["phases"]:
            lines.append(
                f"| {p['phase']} | {p['a']:.1f} | {p['b']:.1f} "
                f"| {_fmt_ratio(p['ratio'])} |"
            )
        lines.append("")
    shown = result["rows"][:top]
    if shown:
        lines += [
            f"## Ranked culprits (top {len(shown)} of {len(result['rows'])})",
            "",
            "| rank | name | phase | A | B | ratio | excess |",
            "|---|---|---|---|---|---|---|",
        ]
        for i, r in enumerate(shown, 1):
            unit = r["unit"]
            excess = "" if r["excess"] is None else f"+{r['excess']:.1f}{unit}"
            lines.append(
                f"| {i} | `{r['name']}` | {r['phase']} | {r['a']:.1f}{unit} "
                f"| {r['b']:.1f}{unit} | {_fmt_ratio(r['ratio'])} | {excess} |"
            )
    else:
        lines.append("No comparable rows shared by the two artifacts.")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("a", help="baseline artifact (obs dump or bench JSON)")
    ap.add_argument("b", help="candidate artifact of the same kind")
    ap.add_argument(
        "--out",
        default=None,
        metavar="PATH",
        help="also write the markdown culprit report here",
    )
    ap.add_argument("--top", type=int, default=20, help="rows shown (default 20)")
    args = ap.parse_args(argv)
    result = diff_artifacts(load_artifact(args.a), load_artifact(args.b))
    print(render_text(result, top=args.top), end="")
    if args.out:
        Path(args.out).write_text(
            render_markdown(
                result,
                top=args.top,
                title=f"Performance diff: {Path(args.a).name} vs {Path(args.b).name}",
            )
        )
        print(f"markdown report written to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
