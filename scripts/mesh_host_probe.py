#!/usr/bin/env python3
"""Measure what ``chip_smoke.py``'s ``[mesh]`` leaves in the process that runs it.

    python3 scripts/mesh_host_probe.py            # [mesh], then [lm] and [lm-train]
    python3 scripts/mesh_host_probe.py --alone    # [lm] and [lm-train] only

Runs ``[mesh]`` in this process (its world-1 references, its dry run, its
ranks), then ``[lm]`` and ``[lm-train]`` after it, as ``chip_smoke.py``
did when ``[mesh]`` ran in its main process.  Before and after each stage
it prints one ``[probe]`` line: the host time of a tiny CUDA op (20,000
of them, no sync between), the CPU time this process burns while it
sleeps for a second, its threads, its live child processes, the objects
the garbage collector tracks and the time of one full collection, and the
host's load average.  Compare the ``[lm-train]`` step ms and the ``[lm]``
decode ms with a run of ``--alone`` (or of ``scripts/lm_train_phase.py``
and ``scripts/lm_phase.py``) in the same chip call.
"""
import argparse
import gc
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path, sets the cuBLAS workspace)


def children() -> int:
    me = str(os.getpid())
    n = 0
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                n += (d / "stat").read_text().rsplit(")", 1)[1].split()[1] == me
            except OSError:
                pass
    return n


def probe(stage: str) -> None:
    x = torch.ones(16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10_000):
        x = x * 1.0001 + 0.0
    op_us = (time.perf_counter() - t0) / 20_000 * 1e6
    torch.cuda.synchronize()
    cpu0 = time.process_time()
    time.sleep(1.0)
    idle_cpu_ms = (time.process_time() - cpu0) * 1e3
    threads = next(int(line.split()[1]) for line in Path("/proc/self/status").read_text()
                   .splitlines() if line.startswith("Threads:"))
    n_obj = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1e3
    load = Path("/proc/loadavg").read_text().split()[:3]
    cs.log(f"[probe] after {stage}: {op_us:.3f} us a tiny op; {idle_cpu_ms:.1f} ms of CPU "
           f"over a 1 s sleep; {threads} threads; {children()} child processes; {n_obj} "
           f"gc objects, a full collection {gc_ms:.1f} ms; load average {' '.join(load)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alone", action="store_true", help="skip [mesh]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.analysis.roofline import spec_for
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev, spec = torch.device("cuda"), spec_for(torch.cuda.get_device_name(0))
    build.build_all()
    probe("the build")
    if not args.alone:
        cs.mesh_phase(dev, spec, smi, after=probe)
    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    wrappers = {name: getattr(K, name) for name in cs.KERNELS}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    cs.lm_phase(dev, spec, smi, reset_counts,
                lambda names: {n: wrappers[n].launches for n in names})
    probe("[lm]")
    cs.lm_train_phase(dev, smi)
    probe("[lm-train]")


if __name__ == "__main__":
    main()
