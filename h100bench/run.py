"""Run one cell of the benchmark once and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  Set-up (graph,
admission, kernel load, warm-up), then ``--seconds`` of the cell's closed
loop, then the comparison with the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks`` comes
last, each number compared beside its limit, as the last lines of
standard error are too.  Exits non-zero, with no result, without a CUDA
card for the cell, without the program, or when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f"h100bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse(argv)
    from h100bench import harness

    try:
        bench = harness.manifest()
        cell, _, _ = harness.cell_files(args.workload, bench)
        harness.import_program()
    except (OSError, KeyError, ValueError, ImportError) as e:
        fail(str(e), 2)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", 3)
    from h100bench.peaks import peaks_for

    try:
        peaks_for(torch.cuda.get_device_name(0))
    except ValueError as e:
        fail(str(e), 3)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as the configurations state
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T0)
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {loaded}", 4)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
