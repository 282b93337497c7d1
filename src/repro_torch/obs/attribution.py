"""Bandwidth attribution: achieved vs modeled bytes per served plan.

The Gao et al. SpMV survey (PAPERS.md) identifies memory bandwidth — not
FLOPs — as the binding constraint, and the kernel layer already models
every launch's device-memory traffic
(:func:`repro_torch.kernels.ops.modeled_launch_bytes` on the stream-pass
model).  This module closes the loop: the serving
engine records, per ``(matrix, strategy, k_tiling)``, the **modeled bytes**
of each flush alongside its **measured compute seconds** (the
``attr.bytes_modeled`` / ``attr.compute_s`` / ``attr.launches``
always-live counters), and :func:`attribution_rows` joins them into

    achieved B/s  =  bytes_modeled / measured_s

compared against a :class:`~repro_torch.analysis.roofline.HardwareSpec`'s
device-memory bandwidth: by default the spec of the caller's card
(``spec_for(torch.cuda.get_device_name(dev))``), which raises when there
is no card; a dump read off the card passes its part's spec as ``hw=``.
A plan running far below its modeled roofline fraction is flagged — the
signal that autotune's admission-time pick no longer matches the traffic
actually served (wrong probe width, cold cache, a neighbor stealing the
device), and the row ``analysis/report.py --attribution`` renders for the
re-tune decision.  A fraction above 1 is a count fault: the model claims
more bytes than the card can move in the measured time.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis.roofline import HardwareSpec, card_spec

__all__ = ["attribution_rows", "has_attribution", "render_attribution", "report"]

# counters the serving engine records per (matrix, strategy, k_tiling)
_ATTR_COUNTERS = ("attr.launches", "attr.bytes_modeled", "attr.compute_s")


def has_attribution(snapshot: dict) -> bool:
    """Whether ``snapshot`` holds any attr.* counter."""
    return any(
        m.get("name") in _ATTR_COUNTERS
        for reg in snapshot.get("registries", [])
        for m in reg.get("metrics", [])
    )


def attribution_rows(
    snapshot: dict,
    *,
    hw: Optional[HardwareSpec] = None,
    device=None,
    flag_below: float = 0.5,
) -> List[dict]:
    """Join the attr.* counters of a ``repro_torch.obs.dump()`` snapshot into
    per-(matrix, strategy, k_tiling) achieved-vs-modeled bandwidth rows.

    ``achieved_gbps`` divides modeled bytes by measured wall seconds (so
    it is the *effective* bandwidth the modeled traffic would imply);
    ``roofline_fraction`` compares that against ``hw.hbm_bw``, and rows
    under ``flag_below`` are marked ``below_roofline`` — the autotune
    re-evaluation candidates.  Rows are sorted by key for deterministic
    artifacts.  ``hw=None`` takes the spec of card ``device`` (default:
    the current one) and raises without a card.
    """
    hw = hw or card_spec(device)
    acc: dict = {}
    for reg in snapshot.get("registries", []):
        for m in reg.get("metrics", []):
            if m.get("name") not in _ATTR_COUNTERS:
                continue
            lab = m.get("labels") or {}
            key = (
                lab.get("matrix", "?"),
                lab.get("strategy", "?"),
                lab.get("k_tiling", "?"),
            )
            d = acc.setdefault(
                key, {"launches": 0, "bytes_modeled": 0.0, "measured_s": 0.0}
            )
            if m["name"] == "attr.launches":
                d["launches"] += int(m["value"])
            elif m["name"] == "attr.bytes_modeled":
                d["bytes_modeled"] += float(m["value"])
            else:
                d["measured_s"] += float(m["value"])
    rows = []
    for (matrix, strategy, k_tiling) in sorted(acc):
        d = acc[(matrix, strategy, k_tiling)]
        sec, byts = d["measured_s"], d["bytes_modeled"]
        achieved = (byts / sec) if sec > 0 else None  # B/s
        frac = (achieved / hw.hbm_bw) if achieved is not None else None
        rows.append(
            {
                "matrix": matrix,
                "strategy": strategy,
                "k_tiling": k_tiling,
                "launches": d["launches"],
                "bytes_modeled": byts,
                "measured_s": sec,
                "modeled_s": byts / hw.hbm_bw,
                "achieved_gbps": achieved / 1e9 if achieved is not None else None,
                "roofline_fraction": frac,
                "below_roofline": (frac is not None and frac < flag_below),
            }
        )
    return rows


def render_attribution(rows: List[dict], *, hw: Optional[HardwareSpec] = None) -> str:
    """Text table over :func:`attribution_rows` output (``hw``: the spec
    the rows were computed against; None means the card's)."""
    if not rows:
        return "(no attribution counters recorded — serve traffic first)\n"
    hw = hw or card_spec()
    header = [
        "matrix", "strategy", "k_tiling", "launches", "MB_modeled",
        "measured_ms", "achieved_GB/s", "roofline%", "flag",
    ]
    table = []
    for r in rows:
        table.append(
            [
                r["matrix"],
                r["strategy"],
                r["k_tiling"],
                str(r["launches"]),
                f"{r['bytes_modeled'] / 1e6:.2f}",
                f"{r['measured_s'] * 1e3:.2f}",
                "-" if r["achieved_gbps"] is None else f"{r['achieved_gbps']:.3f}",
                "-"
                if r["roofline_fraction"] is None
                else f"{100 * r['roofline_fraction']:.1f}",
                "BELOW-ROOFLINE" if r["below_roofline"] else "",
            ]
        )
    widths = [max(len(h), *(len(row[i]) for row in table)) for i, h in enumerate(header)]
    lines = [f"== bandwidth attribution (vs {hw.name} @ {hw.hbm_bw / 1e9:.0f} GB/s) =="]
    lines.append("  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for row in table:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
    flagged = [r for r in rows if r["below_roofline"]]
    if flagged:
        lines.append(
            f"!! {len(flagged)} plan(s) below the modeled-roofline threshold — "
            "re-evaluate their autotuned configs"
        )
    return "\n".join(lines) + "\n"


def report(snapshot: Optional[dict] = None, *, hw: Optional[HardwareSpec] = None) -> str:
    """Live convenience: render attribution over the current process state
    (or a provided snapshot)."""
    if snapshot is None:
        from repro_torch import obs

        snapshot = obs.collect()
    hw = hw or card_spec()
    return render_attribution(attribution_rows(snapshot, hw=hw), hw=hw)
