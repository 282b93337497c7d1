"""Render a ``repro_torch.obs.dump()`` snapshot, or compare two.

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


def _load(path) -> dict:
    return json.loads(Path(path).read_text())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
        ap.error("give one of --obs, --attribution, --requests, --explain, --diff")


if __name__ == "__main__":
    main()
