"""The readings a cell's limits are set from, at the cell's own size, in
one process (set-up once).

    python3 -m h100bench.calibrate --workload <cell> --seeds 1 2 ... \\
        --fault-seeds 7 8 9 [--seconds 1] [--out file.jsonl]

For each seed: the program's numbers against the float64 reference (the
lower readings) and the control's, the reference in TF32 put in the
program's place (the upper readings).  For each fault seed, each fault of
:mod:`h100bench.faults` that the cell's driver lists (``FAULTS``), planted
in the program.  Each driver gives ``Cell`` and ``readings``.  One JSON line per reading
on standard output (and in ``--out``), then the largest program reading,
the smallest control reading and the smallest reading of each fault, per
number.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0,
                   help="window of each seed's run (forwards only)")
    p.add_argument("--size", type=int, default=None,
                   help="log2 of the graph's nodes, for a run smaller than the cell's")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from h100bench import harness
    from h100bench.faults import planted

    harness.import_program()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.manifest()
    cell, workload, config = harness.cell_files(args.workload, bench)
    if args.size is not None:
        workload = {**workload, "graph": {**workload["graph"], "log2_nodes": args.size}}
    device = torch.device("cuda")
    ctx = harness.Context(args.workload, cell, workload, config, args.seeds[0], args.seconds,
                          False, device, T0)
    driver = harness.load_module(harness.HERE / "drivers" / f"{workload['driver']}.py")
    cell_obj = driver.Cell(ctx)
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
        readings = []

        def emit(rec):
            rec = {"workload": args.workload, **rec}
            readings.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        def measure(seed, with_control):
            t = time.perf_counter()
            got, ctrl, detail = driver.readings(cell_obj, seed, args.seconds, with_control)
            return got, ctrl, detail, time.perf_counter() - t

        emit({"setup_s": time.perf_counter() - T0, "admit_s": cell_obj.admit_s})
        for seed in args.seeds:
            got, ctrl, detail, s = measure(seed, True)
            emit({"seed": seed, "program": got, "control": ctrl, "seconds": s, **detail})
        for fault in driver.FAULTS:
            for seed in args.fault_seeds:
                with planted(fault):
                    cell_obj.remake()  # aggregators made now carry the fault
                    got, _, detail, s = measure(seed, False)
                cell_obj.remake()
                emit({"seed": seed, "fault": fault, "program": got, "seconds": s, **detail})

        summary = {}
        progs = [r["program"] for r in readings if "fault" not in r and "program" in r]
        for name in progs[0] if progs else ():
            summary[name] = {
                "lower": max(r[name] for r in progs),
                "control": min(r["control"][name] for r in readings
                               if r.get("control") is not None),
            }
            for fault in driver.FAULTS:
                vals = [r["program"][name] for r in readings if r.get("fault") == fault]
                if vals:
                    summary[name][fault] = min(vals)
        emit({"summary": summary, "device": torch.cuda.get_device_name(device),
              "card": harness.card_line()})


if __name__ == "__main__":
    sys.exit(main())
