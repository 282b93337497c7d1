"""Text dashboard + artifact writer over the metrics/trace snapshots.

:func:`render` turns a collected snapshot (the dict :func:`repro_torch.obs.dump`
writes) into the terminal dashboard; :func:`repro_torch.obs.report` renders the
live process state through the same path, and ``python -m
repro_torch.analysis.report --obs DUMP.json`` re-renders a dumped artifact —
one formatter for live and post-mortem views.
"""
from __future__ import annotations

from typing import List

__all__ = ["render", "amortization_ledger"]


def _fmt(v, unit: str = "") -> str:
    # empty-window percentiles and unset fields arrive as None — render a
    # readable placeholder, never crash and never print a bare "None"
    if v is None:
        return "n/a"
    if isinstance(v, float):
        if v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:.3e}{unit}"
        return f"{v:,.6g}{unit}"
    return f"{v}{unit}"


def _labels(m: dict) -> str:
    lab = m.get("labels") or {}
    if not lab:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(lab.items())) + "}"


def _rows(title: str, header: List[str], rows: List[List[str]]) -> List[str]:
    if not rows:
        return []
    widths = [max(len(h), *(len(r[i]) for r in rows)) for i, h in enumerate(header)]
    out = [f"-- {title} --"]
    out.append("  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    out.append("")
    return out


def amortization_ledger(snapshot: dict) -> List[dict]:
    """The paper's cost ledger, per matrix: one-time preprocessing seconds
    vs requests served, and the amortized cost per request.

    Derived purely from the shared serving counters
    (``registry.preprocess_s`` / ``serving.requests``), so the engine's
    and registry's ``stats()`` views and this ledger can never disagree.
    """
    pre: dict = {}
    req: dict = {}
    for reg in snapshot.get("registries", []):
        for m in reg["metrics"]:
            key = (m.get("labels") or {}).get("matrix")
            if key is None:
                continue
            if m["name"] == "registry.preprocess_s":
                pre[key] = pre.get(key, 0.0) + m["value"]
            elif m["name"] == "serving.requests":
                req[key] = req.get(key, 0.0) + m["value"]
    ledger = []
    for key in sorted(set(pre) | set(req)):
        n = int(req.get(key, 0))
        p = pre.get(key, 0.0)
        ledger.append(
            {
                "matrix": key,
                "preprocess_s": p,
                "requests": n,
                "amortized_preprocess_s": (p / n) if n else None,
            }
        )
    return ledger


def render(snapshot: dict, *, hw=None) -> str:
    """The obs dashboard: counters, gauges, histograms, series, spans.

    ``hw`` is the roofline of the bandwidth-attribution table, shown when
    the snapshot holds ``attr.*`` counters; None means the card's
    (:func:`repro_torch.analysis.roofline.card_spec`, which raises with no
    card: a dump read off the card passes its part's spec).
    """
    counters, gauges, hists, series = [], [], [], []
    for reg in snapshot.get("registries", []):
        rname = reg.get("registry", "")
        for m in reg["metrics"]:
            tag = f"{m['name']}{_labels(m)}"
            if len(snapshot.get("registries", [])) > 1 and rname != "global":
                tag = f"[{rname}] {tag}"
            if m["type"] == "counter":
                counters.append([tag, _fmt(m["value"])])
            elif m["type"] == "gauge":
                gauges.append([tag, _fmt(m["value"])])
            elif m["type"] == "histogram":
                hists.append(
                    [
                        tag,
                        str(m["count"]),
                        _fmt(m.get("p50")),
                        _fmt(m.get("p95")),
                        _fmt(m.get("p99")),
                        _fmt(m.get("max")),
                    ]
                )
            elif m["type"] == "series":
                series.append(
                    [
                        tag,
                        str(m["count"]),
                        _fmt(m.get("first")),
                        _fmt(m.get("last")),
                        _fmt(m.get("min")),
                    ]
                )

    # deterministic dashboards: rows sorted by tag regardless of the order
    # metrics were created in (CI artifacts diff cleanly run-to-run)
    for table in (counters, gauges, hists, series):
        table.sort(key=lambda r: r[0])

    lines: List[str] = ["== repro_torch.obs report =="]
    lines.append("")
    lines += _rows("counters", ["name", "value"], counters)
    lines += _rows("gauges", ["name", "value"], gauges)
    lines += _rows(
        "histograms", ["name", "count", "p50", "p95", "p99", "max"], hists
    )
    lines += _rows("series", ["name", "count", "first", "last", "min"], series)

    ledger = amortization_ledger(snapshot)
    lines += _rows(
        "amortization ledger (preprocess vs traffic)",
        ["matrix", "preprocess_s", "requests", "amortized_s/req"],
        [
            [
                row["matrix"],
                _fmt(row["preprocess_s"]),
                str(row["requests"]),
                _fmt(row["amortized_preprocess_s"]),
            ]
            for row in ledger
        ],
    )

    spans = snapshot.get("spans", [])
    lines += _rows(
        "spans (by total time)",
        ["name", "count", "total_ms", "mean_ms", "max_ms"],
        [
            [
                s["name"],
                str(s["count"]),
                _fmt(s["total_ms"]),
                _fmt(s["mean_ms"]),
                _fmt(s["max_ms"]),
            ]
            for s in spans
        ],
    )
    # bandwidth attribution, when the serving engine recorded attr.* counters
    from .attribution import attribution_rows, has_attribution, render_attribution

    if has_attribution(snapshot):
        from repro_torch.analysis.roofline import card_spec

        hw = hw or card_spec()
        lines.append(render_attribution(attribution_rows(snapshot, hw=hw), hw=hw).rstrip())
        lines.append("")

    # per-request decomposition, when the snapshot carries a request log
    if snapshot.get("requests"):
        from .requesttrace import waterfall

        lines.append(waterfall(snapshot, n=5).rstrip())
        lines.append("")

    fl = snapshot.get("flight")
    if fl and fl.get("recorded_total"):
        lines.append(
            f"-- flight recorder: {fl['events']}/{fl['capacity']} events "
            f"({fl['recorded_total']} recorded, {fl['overwritten']} overwritten, "
            f"{len(fl.get('dumps', []))} dumps, "
            f"{fl.get('suppressed_triggers', 0)} suppressed triggers) --"
        )
        lines.append("")

    dropped = snapshot.get("dropped_events", 0)
    if dropped:
        lines.append(f"!! {dropped} trace events dropped (buffer full)")
    if len(lines) == 2:
        lines.append("(no metrics recorded)")
    return "\n".join(lines).rstrip() + "\n"
