#!/usr/bin/env python3
"""Time the port's fused SpMV/SpMM kernels (sum) on one CUDA card.

    python3 scripts/time_fused.py [--src DIR] [--label NAME] [--sweep 8,16,32,64]
                                  [--profile] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two trees, for instance a parent commit unpacked with ``git archive``
and this one, can be timed with the same code on the same card, in turns
(parent, change, change, parent).  Each tree's kernels build from its own
``csrc``.  For ``m4_kron16`` (tuned geometry) at k = 1, 8, 128 and
``m10_ohne2`` (lane 128) at k = 1, 8 it prints one JSON object per case:
the kernel wrapper's CUDA-event time (the mean over launches filling
``WINDOW_MS``), the whole ``ops`` entry point's,
the kernel's max abs error against its plain version, the least time the
card could take (tile stream, x and y over the card's memory rate) and
one ``torch.sparse_csr_tensor`` product (cuSPARSE) as a yardstick; on a
tree with a chunk index also the chunk chains alone (the fold skipped).
``--profile`` adds the device time of each kernel the wrapper and the
entry point launch, from ``torch.profiler``, which host launch overhead
does not enter.

``--sweep`` (trees with a chunk index only) re-stages ``m4_kron16``'s
chunk index at each ``RUN_CHUNK`` listed and times the kernels there,
whole and without the fold.
"""
import argparse
import dataclasses
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import card_peaks, timed_ms  # noqa: E402

# enough launches that a time covers this many ms of steady work
WINDOW_MS = 100.0


def steady_ms(fn) -> float:
    """Mean CUDA-event time of ``fn`` over launches filling ``WINDOW_MS``."""
    estimate = timed_ms(fn, 5, warmup=3)
    return timed_ms(fn, min(2000, max(10, int(WINDOW_MS / max(estimate, 1e-3)))))


def device_us(fn, calls: int = 50) -> dict:
    """Device time per call of each kernel ``fn`` launches (``torch.profiler``),
    in µs, by kernel name; ``"total"`` is their sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        name = re.split(r"[<(]", name)[0].split("::")[-1].strip()
        out[name] = out.get(name, 0.0) + us / calls
    out["total"] = sum(out.values())
    return out

CASES = (("m4_kron16", 1), ("m4_kron16", 8), ("m4_kron16", 128),
         ("m10_ohne2", 1), ("m10_ohne2", 8))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", action="store_true",
                    help="add each case's device time per kernel (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_fused: needs a CUDA card")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core import PartitionConfig, build_tiles, tuned_partition_config
    from repro_torch.core.matrices import SUITE_SPECS
    from repro_torch.kernels import build, ops

    if not Path(ops.__file__).resolve().is_relative_to(src):
        sys.exit(f"time_fused: imported {ops.__file__}, not from {src}")
    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _, peak_bw, _ = card_peaks(torch.cuda.get_device_name(0))
    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kron = SUITE_SPECS["m4_kron16"](0)
    ohne = SUITE_SPECS["m10_ohne2"](0)
    staged = {
        "m4_kron16": (kron, ops.device_tiles(build_tiles(kron, tuned_partition_config(kron)), dev)),
        "m10_ohne2": (ohne, ops.device_tiles(build_tiles(ohne, PartitionConfig(lane=128)), dev)),
    }
    rows = []

    def emit(row):
        row.update(label=args.label, card=smi)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def kernel_of(k):
        return (K.hbp_spmv_fused, K.hbp_spmv_fused_plain) if k == 1 else (
            K.hbp_spmm_fused, K.hbp_spmm_fused_plain)

    def rhs(dt, k):
        X = torch.randn(dt.shape[1], k, device=dev, generator=g)
        return X[:, 0].contiguous() if k == 1 else X

    for name, k in CASES:
        csr, dt = staged[name]
        arg = rhs(dt, k)
        kern, plain = kernel_of(k)
        err = (kern(dt, arg) - plain(dt, arg)).abs().max().item()
        ms = steady_ms(lambda: kern(dt, arg))
        entry = ops.hbp_spmv if k == 1 else ops.hbp_spmm
        entry_ms = steady_ms(lambda: entry(dt, arg, strategy="fused"))
        A = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data, dtype=torch.float32), size=csr.shape).to(dev)
        library_ms = steady_ms(lambda: A @ arg)
        group = dt.data.shape[1]
        moved = (dt.data.nbytes + dt.cols.nbytes + dt.colblock.nbytes + dt.run_start.nbytes
                 + dt.run_rowgroup.nbytes + dt.shape[1] * k * 4
                 + dt.n_rowgroups * group * k * 4)
        row = {"matrix": name, "k": k, "ms": ms, "entry_ms": entry_ms, "max_abs_err": err,
               "bound_ms": moved / peak_bw * 1e3, "library_ms": library_ms}
        if args.profile:
            row["kernel_device_us"] = device_us(lambda: kern(dt, arg))
            row["entry_device_us"] = device_us(lambda: entry(dt, arg, strategy="fused"))
        if hasattr(dt, "chunk_start"):
            row.update(run_chunk=ops.RUN_CHUNK, n_chunks=int(dt.chunk_dest.shape[0]),
                       n_split=int(dt.split_run.shape[0]),
                       chunk_buffer_bytes=dt.chunk_buffer_nbytes(k))
            # the chunk chains alone: the same launch with no split run to fold
            chains = dataclasses.replace(dt, split_run=dt.split_run[:0])
            row["chains_ms"] = steady_ms(lambda: kern(chains, arg))
        emit(row)

    if args.sweep:
        csr, dt = staged["m4_kron16"]
        rs, rr = dt.run_start.cpu().numpy(), dt.run_rowgroup.cpu().numpy()

        def put(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev)

        for limit in (int(v) for v in args.sweep.split(",")):
            cs, rc, dest, split = ops.chunk_index(rs, rr, limit)
            dl = dataclasses.replace(
                dt, chunk_start=put(cs), run_chunk=put(rc), chunk_dest=put(dest),
                split_run=put(split), n_split_chunks=int(np.count_nonzero(dest < 0)))
            for k in (1, 8, 128):
                arg = rhs(dl, k)
                kern, plain = kernel_of(k)
                err = (kern(dl, arg) - plain(dl, arg)).abs().max().item()
                chains = dataclasses.replace(dl, split_run=dl.split_run[:0])
                emit({"sweep_run_chunk": limit, "matrix": "m4_kron16", "k": k,
                      "ms": steady_ms(lambda: kern(dl, arg)),
                      "chains_ms": steady_ms(lambda: kern(chains, arg)),
                      "max_abs_err": err, "n_chunks": int(len(dest)),
                      "n_split": int(len(split)), "chunk_buffer_bytes": dl.chunk_buffer_nbytes(k)})
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
