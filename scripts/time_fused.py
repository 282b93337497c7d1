#!/usr/bin/env python3
"""Time the port's SpMV/SpMM kernels (fused or partials sum, or the max) on one CUDA card.

    python3 scripts/time_fused.py [--family fused|partials|max] [--src DIR] [--label NAME]
                                  [--sweep 8,16,32,64] [--geometry-sweep]
                                  [--profile] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two trees, for instance a parent commit unpacked with ``git archive``
and this one, can be timed with the same code on the same card, in turns
(parent, change, change, parent).  Each tree's kernels build from its own
``csrc``.  Every case prints one JSON object: the kernel wrapper's
CUDA-event time (the mean over launches filling ``WINDOW_MS``), the whole
``ops`` entry point's, the kernel's max abs error against its plain
version, the least time the card could take for the kernel's own work
(``bound_ms``: its inputs read once and its output written once over the
card's memory rate), one ``torch.sparse_csr_tensor`` product (cuSPARSE)
as a yardstick, and a SHA-256 of the kernel's output bytes, so that two
trees can be checked bitwise on the same inputs (x is drawn from a seed
per case).  ``--profile`` adds the device time of each kernel the wrapper,
the entry point and the cuSPARSE product launch, from ``torch.profiler``,
which host launch overhead does not enter.

``--family fused`` (the default): kernels 1-2 on ``m4_kron16`` (tuned
geometry) at k = 1, 8, 128 and ``m10_ohne2`` (lane 128) at k = 1, 8; on a
tree with a chunk index also the chunk chains alone (the fold skipped).
``--sweep`` (trees with a chunk index only) re-stages ``m4_kron16``'s
chunk index at each ``RUN_CHUNK`` listed and times the kernels there,
whole and without the fold.

``--family partials``: kernels 5-6 on ``m4_kron16`` at k = 1, 8, 128,
256, ``m10_ohne2`` at k = 1, 8 and the hub-run matrix of
``tests/hub_runs.py`` at k = 1, 8, 128, 256, with the combine
(``segment_reduce`` over the partials) timed alone.  ``--geometry-sweep``
(trees with ``partials_geometry`` only) times other launch geometries of
the same kernels (columns and rows per thread, column units per slab).

``--family max``: kernels 3-4 (the fused and the partials max) on
``m4_kron16`` at k = 8, 128, 256, ``m10_ohne2`` at k = 8 and the hub-run
matrix at k = 8, 128, 256, each with its entry point
(``ops.hbp_spmm(combine="max")``; for the partials the plain combine
timed alone too, ``segment_reduce`` alone, and, on trees whose kernel 4
takes ``runs``, kernel 4 with its run combine kernel, ``runs_ms``), its own bound (``chip_smoke.kernel_bytes``) and a SHA-256;
then a 3-layer GraphSAGE-max forward (the ``chip_smoke.py`` graph phase's
model and graph) under ``"fused"`` and ``"partials"``.  Its
``--geometry-sweep`` (trees whose max kernels take a launch geometry)
times other geometries of both: one column and one row a thread is the
fused max as one thread per (chunk, g, c).
"""
import argparse
import dataclasses
import hashlib
import importlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import GNN_DIMS, card_peaks, kernel_bytes, timed_ms  # noqa: E402

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


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


CASES = (("m4_kron16", 1), ("m4_kron16", 8), ("m4_kron16", 128),
         ("m10_ohne2", 1), ("m10_ohne2", 8))
PARTIALS_CASES = (("m4_kron16", 1), ("m4_kron16", 8), ("m4_kron16", 128), ("m4_kron16", 256),
                  ("m10_ohne2", 1), ("m10_ohne2", 8),
                  ("hub", 1), ("hub", 8), ("hub", 128), ("hub", 256))
MAX_CASES = (("m4_kron16", 8), ("m4_kron16", 128), ("m4_kron16", 256), ("m10_ohne2", 8),
             ("hub", 8), ("hub", 128), ("hub", 256))
# (matrix, k) -> launch geometries (width, rows, slab) of the max kernels'
# --geometry-sweep; (1, 1, min(k, 32)) is one thread per output element
_WIDE = [(1, 1, 32), (4, 1, 8), (4, 1, 16)] + [(4, r, 32) for r in (1, 2, 4, 8)]
MAX_GEOMETRIES = {
    ("m4_kron16", 8): [(1, 1, 8), (4, 1, 1)] + [(4, r, 2) for r in (1, 2, 4, 8)],
    ("m4_kron16", 128): _WIDE,
    ("m4_kron16", 256): _WIDE,
    ("hub", 8): [(1, 1, 8), (4, 1, 2), (4, 2, 2)],
    ("hub", 128): _WIDE,
}
# (matrix, k) -> launch geometries (width, rows, slab) of --geometry-sweep
GEOMETRIES = {
    ("m4_kron16", 1): [(1, r, 1) for r in (1, 2, 4, 8)],
    ("m4_kron16", 8): [(4, r, 2) for r in (1, 2, 4, 8)],
    ("m4_kron16", 128): [(4, r, 32) for r in (1, 2, 4, 8)] + [(4, 4, 16)],
    ("m4_kron16", 256): [(4, r, 32) for r in (1, 2, 4, 8)],
    ("m10_ohne2", 1): [(1, r, 1) for r in (1, 2, 4)],
    ("m10_ohne2", 8): [(4, r, 2) for r in (1, 2, 4)],
}


def max_family(args, staged, K, ops, ref, dev, g, emit, peak_bw) -> None:
    """Kernels 3-4, their entry points and the GraphSAGE-max forward."""
    kernels = (("hbp_spmm_fused_max", "fused"), ("hbp_spmm_partials_max", "partials"))
    for i, (name, k) in enumerate(MAX_CASES):
        _, dt = staged[name]
        g.manual_seed(3000 + i)  # the same x in every tree
        X = torch.randn(dt.shape[1], k, device=dev, generator=g)
        for kname, strategy in kernels:
            kern, plain = getattr(K, kname), getattr(K, kname + "_plain")
            out = kern(dt, X)
            row = {"family": "max", "kernel": kname, "matrix": name, "k": k,
                   "exact": bool(torch.equal(out, plain(dt, X))), "sha256": sha256(out),
                   "ms": steady_ms(lambda: kern(dt, X)),
                   "entry_ms": steady_ms(lambda: ops.hbp_spmm(dt, X, strategy=strategy,
                                                              combine="max")),
                   "bound_ms": kernel_bytes(kname, dt, k) / peak_bw * 1e3}
            if strategy == "partials":
                # the plain combine (segment_reduce, then the +0.0 pass) and
                # segment_reduce alone, the combine before that pass
                row["combine_ms"] = steady_ms(lambda: ref.segment_max_sorted(
                    out, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths))
                row["segment_reduce_ms"] = steady_ms(lambda: torch.segment_reduce(
                    out, "max", lengths=dt.rg_lengths, axis=0, unsafe=True,
                    initial=float("-inf")))
                if "runs" in inspect.signature(kern).parameters:
                    # kernel 4 and its run combine kernel in one launch call
                    runs = kern(dt, X, runs=True)
                    row["runs_ms"] = steady_ms(lambda: kern(dt, X, runs=True))
                    row["runs_sha256"] = sha256(runs)
                    row["runs_exact"] = bool(torch.equal(
                        runs.view(torch.int32), plain(dt, X, runs=True).view(torch.int32)))
                    del runs
            else:
                row.update(n_chunks=int(dt.chunk_dest.shape[0]),
                           n_split=int(dt.split_run.shape[0]),
                           chunk_buffer_bytes=dt.chunk_buffer_nbytes(k))
            if args.profile:
                row["kernel_device_us"] = device_us(lambda: kern(dt, X))
                row["entry_device_us"] = device_us(
                    lambda: ops.hbp_spmm(dt, X, strategy=strategy, combine="max"))
            del out
            emit(row)
            sweep = MAX_GEOMETRIES.get((name, k), ()) if args.geometry_sweep else ()
            for width, rows_, slab in sweep:
                group = dt.data.shape[1]
                if strategy == "fused":
                    n_items = int(dt.chunk_dest.shape[0])
                    y = torch.full((dt.n_rowgroups, group, k), float("-inf"), device=dev)
                    launch = lambda: K._fused_max(dt, X, y, geometry=geo)  # noqa: E731
                else:
                    n_items = dt.n_tiles
                    y = torch.empty((dt.n_tiles, group, k), device=dev)
                    launch = lambda: K._partials_launch(  # noqa: E731
                        "hbp_spmm_partials_max_launch", dt, X, y, k, geometry=geo)
                geo = K._geometry(n_items, group, k, width, rows_, slab)
                launch()
                row = {"family": "max", "kernel": kname, "geometry": [width, rows_, slab],
                       "matrix": name, "k": k, "sha256": sha256(y), "ms": steady_ms(launch)}
                if args.profile:
                    row["kernel_device_us"] = device_us(launch)
                emit(row)
                del y
    # the chip_smoke.py graph phase's GraphSAGE-max forward, both strategies
    import tempfile

    from repro_torch.graph import GraphSAGE, plan_aggregator, rmat_graph
    from repro_torch.serving import MatrixRegistry

    A = rmat_graph(1 << 16, 79.345703125, seed=4)
    feats = torch.randn(A.shape[0], GNN_DIMS[0], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    model = GraphSAGE(GNN_DIMS, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    with tempfile.TemporaryDirectory() as cache, torch.inference_mode():
        for strategy in ("fused", "partials"):
            reg = MatrixRegistry(device="cuda", cache_dir=cache, search=False, strategy=strategy)
            agg = plan_aggregator(reg.admit(A, "A"), op="max")
            out = model(agg, feats)
            row = {"family": "max", "forward": "sage-max", "strategy": strategy,
                   "sha256": sha256(out), "ms": steady_ms(lambda: model(agg, feats))}
            if args.profile:
                row["device_us"] = device_us(lambda: model(agg, feats), calls=10)
            emit(row)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--family", choices=("fused", "partials", "max"), default="fused")
    ap.add_argument("--sweep", default="")
    ap.add_argument("--geometry-sweep", action="store_true",
                    help="partials: time other launch geometries of the same kernels")
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", action="store_true",
                    help="add each case's device time per kernel (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_fused: needs a CUDA card")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core import COOMatrix, PartitionConfig, build_tiles, csr_from_coo
    from repro_torch.core import tuned_partition_config
    from repro_torch.core.matrices import SUITE_SPECS
    from repro_torch.kernels import build, ops

    if not Path(ops.__file__).resolve().is_relative_to(src):
        sys.exit(f"time_fused: imported {ops.__file__}, not from {src}")
    from repro_torch.kernels import ref

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    sys.path.insert(0, str(ROOT / "tests"))
    from hub_runs import hub_config, hub_coo
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
    if args.family in ("partials", "max"):
        hub = csr_from_coo(COOMatrix(*hub_coo(ops.RUN_CHUNK, 8)))
        staged["hub"] = (hub, ops.device_tiles(build_tiles(hub, PartitionConfig(**hub_config(8))),
                                               dev))
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

    def csr_tensor(csr):
        return torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data, dtype=torch.float32), size=csr.shape).to(dev)

    if args.family == "partials":
        for i, (name, k) in enumerate(PARTIALS_CASES):
            csr, dt = staged[name]
            g.manual_seed(1000 + i)  # the same x in every tree
            arg = rhs(dt, k)
            kern, plain = ((K.hbp_spmv_partials, K.hbp_spmv_partials_plain) if k == 1
                           else (K.hbp_spmm_partials, K.hbp_spmm_partials_plain))
            out = kern(dt, arg)
            err = (out - plain(dt, arg)).abs().max().item()
            digest = sha256(out)
            view = out[..., None] if k == 1 else out
            del out
            entry = ops.hbp_spmv if k == 1 else ops.hbp_spmm
            A = csr_tensor(csr)
            T, group, _ = dt.data.shape
            row = {"family": "partials", "matrix": name, "k": k,
                   "ms": steady_ms(lambda: kern(dt, arg)),
                   "entry_ms": steady_ms(lambda: entry(dt, arg, strategy="partials")),
                   "combine_ms": steady_ms(lambda: ref.segment_sum_sorted(
                       view, dt.rowgroup, dt.n_rowgroups, dt.rg_lengths)),
                   "library_ms": steady_ms(lambda: A @ arg),
                   "bound_ms": kernel_bytes("hbp_spmm_partials", dt, k) / peak_bw * 1e3,
                   "max_abs_err": err, "sha256": digest}
            if args.profile:
                row["kernel_device_us"] = device_us(lambda: kern(dt, arg))
                row["entry_device_us"] = device_us(lambda: entry(dt, arg, strategy="partials"))
                row["library_device_us"] = device_us(lambda: A @ arg)
            emit(row)
            del view
            sweep = GEOMETRIES.get((name, k), ()) if args.geometry_sweep else ()
            for width, rows_, slab in sweep:
                geo = K._geometry(dt.n_tiles, group, k, width, rows_, slab)
                out = torch.empty((T, group, k), dtype=torch.float32, device=dev)

                def launch():
                    K._partials_launch("hbp_spmm_partials_launch", dt, arg, out, k, geometry=geo)

                launch()
                row = {"family": "partials", "geometry": [width, rows_, slab], "matrix": name,
                       "k": k, "sha256": sha256(out), "ms": steady_ms(launch)}
                if args.profile:
                    row["kernel_device_us"] = device_us(launch)
                emit(row)
                del out

    if args.family == "max":
        max_family(args, staged, K, ops, ref, dev, g, emit, peak_bw)

    for i, (name, k) in enumerate(CASES if args.family == "fused" else ()):
        csr, dt = staged[name]
        g.manual_seed(2000 + i)  # the same x in every tree
        arg = rhs(dt, k)
        kern, plain = kernel_of(k)
        out = kern(dt, arg)
        err = (out - plain(dt, arg)).abs().max().item()
        digest = sha256(out)
        del out
        ms = steady_ms(lambda: kern(dt, arg))
        entry = ops.hbp_spmv if k == 1 else ops.hbp_spmm
        entry_ms = steady_ms(lambda: entry(dt, arg, strategy="fused"))
        A = csr_tensor(csr)
        library_ms = steady_ms(lambda: A @ arg)
        row = {"matrix": name, "k": k, "ms": ms, "entry_ms": entry_ms, "max_abs_err": err,
               "bound_ms": kernel_bytes("hbp_spmm_fused", dt, k) / peak_bw * 1e3,
               "library_ms": library_ms, "sha256": digest}
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

    if args.sweep and args.family == "fused":
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
