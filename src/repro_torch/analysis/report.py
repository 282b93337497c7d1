"""Render the dry-run tables, a ``repro_torch.obs.dump()`` snapshot, or a comparison.

With no mode flag, the roofline and dry-run tables of the records that
``python -m repro_torch.launch.dryrun`` wrote to ``--dir``, the JAX
package's tables for the same records::

    PYTHONPATH=src python -m repro_torch.analysis.report --dir experiments/dryrun_torch

``--obs PATH`` re-renders the text dashboard (counters, histograms, span
aggregates, amortized-preprocess ledger, bandwidth attribution)::

    PYTHONPATH=src python -m repro_torch.analysis.report --obs obs.json

``--attribution PATH`` renders only the bandwidth-attribution join:
achieved vs modeled bytes per (matrix, strategy, k_tiling), flagging plans
below the modeled roofline (:mod:`repro_torch.obs.attribution`)::

    PYTHONPATH=src python -m repro_torch.analysis.report --attribution obs.json

``--requests PATH`` renders the slowest-N request waterfall from the
snapshot's request log (queue wait vs compute share, trace ids; ``--top``
bounds N)::

    PYTHONPATH=src python -m repro_torch.analysis.report --requests obs.json --top 10

``--explain MATRIX`` renders the per-matrix explain report — partition
quality, autotune provenance, modeled-vs-measured bandwidth and the
imbalance verdict — from the ``--obs`` snapshot (default
``serve_obs.json``)::

    PYTHONPATH=src python -m repro_torch.analysis.report --explain m4_kron16 --obs obs.json

``--diff A B`` compares two obs dumps (or two ``benchmarks.run --json``
artifacts) and prints the ranked culprit table
(:mod:`repro_torch.analysis.diff`).

The roofline of the attribution and explain views is the card's
(:func:`repro_torch.analysis.roofline.card_spec`); ``--hw NAME`` names the
part instead (a device name as ``nvidia-smi`` prints it, or a spec name
such as ``h100_sxm``), which a dump read off the card needs.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ARCH_ORDER = [
    "llava-next-34b", "olmo-1b", "mistral-nemo-12b", "internlm2-20b",
    "nemotron-4-340b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
    "mamba2-370m", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _load(path) -> dict:
    return json.loads(Path(path).read_text())


def load(dirpath: Path):
    """The dry-run records of a directory, by (arch, shape, mesh)."""
    recs = {}
    for p in Path(dirpath).glob("*.json"):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bound | t_bound | useful/HLO | fits |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, "single"))
            if r is None:
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | MISSING |")
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | skip (full-attn @500k) |")
                continue
            if r["status"] != "ok" or "roofline" not in r:
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | {r['status']} |")
                continue
            rf = r["roofline"]
            tb = max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
            ratio = r.get("model_flops_ratio") or 0
            lines.append(
                f"| {arch} | {shape} | {fmt_s(rf['t_compute_s'])} | "
                f"{fmt_s(rf['t_memory_s'])} | {fmt_s(rf['t_collective_s'])} | "
                f"{rf['bottleneck']} | {fmt_s(tb)} | {ratio:.2f} | "
                f"{'✓' if r['fits_hbm'] else 'OVER'} |"
            )
    return "\n".join(lines)


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | status | peak GiB | fits | compile s | n_micro |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in ("single", "multipod"):
                r = recs.get((arch, shape, mesh))
                if r is None:
                    lines.append(f"| {arch} | {shape} | {mesh} | MISSING | | | | |")
                    continue
                if r["status"] != "ok":
                    lines.append(
                        f"| {arch} | {shape} | {mesh} | {r['status']} | | | | |"
                    )
                    continue
                m = r["memory"]
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok | "
                    f"{m['peak_estimate_bytes']/2**30:.2f} | "
                    f"{'✓' if r['fits_hbm'] else 'OVER'} | {r['compile_s']} | "
                    f"{r.get('n_microbatch', '')} |"
                )
    return "\n".join(lines)


def fleet_stats(recs) -> str:
    """One line of counts; the memory a record fits in is its own
    ``memory.hbm_bytes``."""
    ok = [r for r in recs.values() if r["status"] == "ok"]
    skipped = [r for r in recs.values() if r["status"] == "skipped"]
    err = [r for r in recs.values() if r["status"] == "error"]
    fits = [r for r in ok if r.get("fits_hbm")]
    budget = " or ".join(f"{b / 1e9:g} GB" for b in
                         sorted({r["memory"]["hbm_bytes"] for r in ok})) or "—"
    return (
        f"cells: {len(recs)} recorded — {len(ok)} compiled ok "
        f"({len(fits)} fit in {budget}/chip), {len(skipped)} skipped per "
        f"assignment sheet, {len(err)} errors"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch",
                    help="the dry-run records to render (no mode flag given)")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="render the dashboard from a repro_torch.obs.dump() snapshot")
    ap.add_argument("--attribution", default=None, metavar="PATH",
                    help="render achieved-vs-modeled bandwidth per (matrix, strategy, "
                    "k_tiling) from a snapshot")
    ap.add_argument("--requests", default=None, metavar="PATH",
                    help="render the slowest-N request waterfall from a snapshot")
    ap.add_argument("--top", type=int, default=20,
                    help="rows the --requests waterfall and --diff table show (default 20)")
    ap.add_argument("--explain", default=None, metavar="MATRIX",
                    help="render the per-matrix explain report from the --obs snapshot "
                    "(default serve_obs.json)")
    ap.add_argument("--diff", nargs=2, default=None, metavar=("A", "B"),
                    help="differential comparison of two obs dumps or two "
                    "benchmarks.run --json artifacts (ranked culprit table)")
    ap.add_argument("--hw", default=None, metavar="NAME",
                    help="the part whose peak rates the attribution is held against "
                    "(default: this machine's card)")
    args = ap.parse_args(argv)
    hw = None
    if args.hw is not None:
        from repro_torch.analysis.roofline import spec_for

        hw = spec_for(args.hw)
    if args.diff:
        from repro_torch.analysis.diff import diff_artifacts, render_text

        a, b = args.diff
        print(render_text(diff_artifacts(_load(a), _load(b)), top=args.top), end="")
    elif args.explain:
        from repro_torch.obs.planview import explain_report

        print(explain_report(_load(args.obs or "serve_obs.json"), args.explain, hw=hw),
              end="")
    elif args.requests:
        from repro_torch.obs.requesttrace import waterfall

        print(waterfall(_load(args.requests), n=args.top))
    elif args.attribution:
        from repro_torch.analysis.roofline import card_spec
        from repro_torch.obs.attribution import attribution_rows, render_attribution

        hw = hw or card_spec()
        print(render_attribution(attribution_rows(_load(args.attribution), hw=hw), hw=hw))
    elif args.obs:
        from repro_torch.obs.report import render

        print(render(_load(args.obs), hw=hw))
    else:
        recs = load(Path(args.dir))
        print("## §Roofline (single-pod 16×16, per-device per-step seconds)\n")
        print(roofline_table(recs))
        print("\n## §Dry-run matrix\n")
        print(fleet_stats(recs) + "\n")
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
