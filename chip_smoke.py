#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   and print ptxas's register / shared-memory / spill lines;
3. kernels — each kernel against its plain PyTorch version on
   ``m4_kron16`` (65,536 rows, the size of SuiteSparse ``kron_g500-logn16``,
   tuned geometry) and ``m10_ohne2`` (lane 128 pinned), tolerance
   ``rtol=1e-5, atol=1e-5 * max(1, |y_plain|_inf)``; the bitwise invariants
   (SpMV equals the SpMM column at k = 1, 8, 128 and under bucket
   padding; ``grid`` equals ``loop`` at k = 256; ``"stable"`` is
   batch-width invariant); row groups without tiles come out 0;
4. serving — ``MatrixRegistry(device="cuda")`` admits ``m4_kron16`` with
   the heuristic geometry and ``m1_asic320k`` with a measured search
   (CUDA-event probe); ``ServingEngine`` serves mixed k = 1..16 traffic
   over both, synchronous and overlapped.  Every answer is checked against
   a float64 CSR product (``|y - y64| <= 1e-5 * (|A| |x|) + 1e-30``) and
   bitwise against ``plan.matvec``; both kernels' launch counters must
   have risen during this phase;
5. times   — CUDA-event times of each kernel, its plain version and the
   ``torch.sparse_csr_tensor`` product (a yardstick the port never calls)
   on ``m4_kron16``, beside the least time the card could take.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SOURCE = "src/repro_torch/kernels/csrc/hbp_spmv.cu"
REPLACES = {
    "hbp_spmv_fused": "src/repro/kernels/hbp_spmv.py:139",
    "hbp_spmm_fused": "src/repro/kernels/hbp_spmv.py:202",
}
RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*args) -> None:
    print(*args, flush=True)


# device-memory rate (bytes/s) and float32 rate outside the tensor cores
# (flop/s) of each part, from NVIDIA's data sheets
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
)


def card_peaks(name: str):
    for part, bw, flops in PEAKS:
        if all(word in name for word in part.split()):
            return part, bw, flops
    fail(f"no peak rates known for {name!r}")


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of one call over ``iters`` calls after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err_within(y, y_plain, what: str) -> float:
    err = (y - y_plain).abs()
    tol = RTOL * y_plain.abs() + RTOL * max(1.0, y_plain.abs().max().item())
    check(bool(torch.all(err <= tol)), f"{what}: kernel disagrees with its plain version "
          f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.core import PartitionConfig, build_tiles, csr_from_dense
    from repro_torch.core import enumerate_configs, tuned_partition_config
    from repro_torch.core.matrices import SUITE_SPECS
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.hbp_spmv import (
        hbp_spmm_fused,
        hbp_spmm_fused_plain,
        hbp_spmv_fused,
        hbp_spmv_fused_plain,
    )
    from repro_torch.serving import MatrixRegistry, QoSClass, ServingEngine

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # --- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    part, peak_bw, peak_flops = card_peaks(kind)
    log(f"[device] {smi_line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
        f"peaks of the {part}: {peak_bw / 1e12} TB/s, {peak_flops / 1e12} TFLOP/s f32")

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # --- 3. kernels against their plain versions ----------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    kron = SUITE_SPECS["m4_kron16"](0)
    kron_cfg = tuned_partition_config(kron)
    kron_tiles = build_tiles(kron, kron_cfg)
    dt = ops.device_tiles(kron_tiles, dev)
    log(f"[kernels] m4_kron16 {kron.shape} nnz={kron.nnz} cfg={kron_cfg} "
        f"tiles={kron_tiles.n_tiles} stream={kron_tiles.data.nbytes + kron_tiles.cols.nbytes} B "
        f"built in {time.perf_counter() - t0:.1f} s")
    # one thread walks a whole row-group run: the longest run bounds the
    # kernels' time from below on this matrix
    run_len = np.diff(dt.run_start.cpu().numpy())
    log(f"[kernels] m4_kron16 runs={run_len.size} tiles/run mean={run_len.mean():.1f} "
        f"max={run_len.max()} ({run_len.max() * kron_cfg.lane} serial multiply-adds per thread)")
    ohne = SUITE_SPECS["m10_ohne2"](0)
    ohne_cfg = PartitionConfig(lane=128)
    dt_ohne = ops.device_tiles(build_tiles(ohne, ohne_cfg), dev)

    errs = {}
    for label, d in (("m4_kron16", dt), ("m10_ohne2", dt_ohne)):
        x = torch.randn(d.shape[1], device=dev, generator=g)
        y = hbp_spmv_fused(d, x)
        errs[(label, 1)] = max_err_within(y, hbp_spmv_fused_plain(d, x), f"{label} spmv")
        for k in (8, 128):
            X = torch.randn(d.shape[1], k, device=dev, generator=g)
            c = k // 2
            X[:, c] = x
            Y = hbp_spmm_fused(d, X)
            errs[(label, k)] = max_err_within(Y, hbp_spmm_fused_plain(d, X), f"{label} spmm k={k}")
            check(torch.equal(Y[..., c], y), f"{label}: SpMV != SpMM column at k={k}")
        Y1 = hbp_spmm_fused(d, x[:, None].contiguous())
        check(torch.equal(Y1[..., 0], y), f"{label}: SpMV != SpMM at k=1")
        # through the entry points: bucket padding (5 -> 8) and k tiling
        y_served = ops.hbp_spmv(d, x)
        X5 = torch.randn(d.shape[1], 5, device=dev, generator=g)
        X5[:, 3] = x
        check(torch.equal(ops.hbp_spmm_bucketed(d, X5)[:, 3], y_served),
              f"{label}: bucket-padded column != SpMV")
        X256 = torch.randn(d.shape[1], 256, device=dev, generator=g)
        check(torch.equal(ops.hbp_spmm(d, X256, k_tiling="grid"),
                          ops.hbp_spmm(d, X256, k_tiling="loop")),
              f"{label}: k=256 grid != loop")
        log(f"[kernels] {label}: max abs err vs plain "
            + ", ".join(f"k={k}: {e:.3e}" for (lab, k), e in errs.items() if lab == label)
            + "; bitwise SpMV == SpMM column (k=1, 8, 128, bucket 5->8); grid == loop at k=256")
    # "stable" (the torch lane chain) is batch-width invariant on the card
    x = torch.randn(dt.shape[1], device=dev, generator=g)
    y_st = ops.hbp_spmv(dt, x, strategy="stable")
    for k in (1, 8, 128):
        X = torch.randn(dt.shape[1], k, device=dev, generator=g)
        X[:, k - 1] = x
        check(torch.equal(ops.hbp_spmm(dt, X, strategy="stable")[:, k - 1], y_st),
              f"stable: column at k={k} != SpMV")
    X5 = torch.randn(dt.shape[1], 5, device=dev, generator=g)
    X5[:, 0] = x
    check(torch.equal(ops.hbp_spmm_bucketed(dt, X5, strategy="stable")[:, 0], y_st),
          "stable: bucket-padded column != SpMV")
    log("[kernels] stable: bitwise batch-width invariant at k=1, 8, 128 and bucket 5->8")
    # row groups that own no tiles come out exactly 0
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((4096, 3000)) * (rng.random((4096, 3000)) < 0.01)
    dense[512:2560] = 0.0
    holes = build_tiles(csr_from_dense(dense), PartitionConfig(lane=8))
    empty = np.setdiff1d(np.arange(holes.n_rowgroups), holes.rowgroup)
    check(empty.size > 0, "the empty-row matrix has no empty row group")
    dh = ops.device_tiles(holes, dev)
    Xh = torch.randn(3000, 8, device=dev, generator=g)
    check(bool(torch.all(hbp_spmm_fused(dh, Xh)[torch.as_tensor(empty, device=dev)] == 0)),
          "empty row groups are not zero (spmm)")
    check(bool(torch.all(hbp_spmv_fused(dh, Xh[:, 0].contiguous())[
        torch.as_tensor(empty, device=dev)] == 0)), "empty row groups are not zero (spmv)")
    kron_empty = kron_tiles.n_rowgroups - len(np.unique(kron_tiles.rowgroup))
    log(f"[kernels] empty row groups are 0: {empty.size} of {holes.n_rowgroups} "
        f"(synthetic), m4_kron16 has {kron_empty}")

    # --- 4. serving: the main path ------------------------------------------
    asic = SUITE_SPECS["m1_asic320k"](0)
    candidates = enumerate_configs(
        asic.shape, row_blocks=(512,), col_blocks=(4096,), lanes=(8, 16, 32)
    )
    hbp_spmv_fused.launches = 0
    hbp_spmm_fused.launches = 0
    with tempfile.TemporaryDirectory() as cache:
        # flight-recorder dumps (if a latency anomaly fires) stay out of the tree
        os.environ["REPRO_FLIGHT_DIR"] = cache
        registry = MatrixRegistry(device="cuda", cache_dir=cache, candidates=candidates)
        check(registry.strategy == "fused", f"default strategy on the card is {registry.strategy}")
        registry.search = False  # kron16: the nnz-profile heuristic
        plan_k = registry.admit(kron, "m4_kron16")
        registry.search = True  # asic: measured search with the CUDA-event probe
        plan_a = registry.admit(asic, "m1_asic320k")
        check(plan_a.autotune_searched and len(plan_a.provenance["trials"]) == len(candidates),
              "the measured search did not run")
        log(f"[serving] admitted m4_kron16 cfg={plan_k.cfg} in {plan_k.preprocess_s:.1f} s; "
            f"m1_asic320k searched {len(candidates)} geometries in {plan_a.preprocess_s:.1f} s: "
            + ", ".join(f"lane {t['config']['lane']}: {t['objective_us']} us"
                        for t in plan_a.provenance["trials"]))
        plans = {"m4_kron16": plan_k, "m1_asic320k": plan_a}
        csrs = {"m4_kron16": kron, "m1_asic320k": asic}
        ref = {}  # per matrix: row of each entry, entry values as served (f32)
        for key, csr in csrs.items():
            ref[key] = (np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr)),
                        csr.data.astype(np.float32).astype(np.float64))
        bursts = [1, 16, 2, 11, 3, 8, 5, 16]  # 62 requests, batch widths 1..16
        xrng = np.random.default_rng(3)
        for overlap in (False, True):
            # max_wait_s=0: each poll dispatches what is queued, so batch
            # widths follow the bursts; a 1 s deadline class for accounting
            eng = ServingEngine(
                registry, max_batch=16, max_wait_s=0.0, overlap=overlap,
                default_qos=QoSClass("smoke", deadline_s=1.0),
            )
            sent = []
            t0 = time.perf_counter()
            for i, size in enumerate(bursts):
                key = ("m4_kron16", "m1_asic320k")[i % 2]
                for _ in range(size):
                    x = xrng.standard_normal(csrs[key].shape[1]).astype(np.float32)
                    sent.append((key, x, eng.submit(key, x)))
                eng.poll()
            eng.flush()
            wall = time.perf_counter() - t0
            for key, x, ticket in sent:
                y = ticket.result()
                csr = csrs[key]
                rows, a = ref[key]
                xv = x.astype(np.float64)[csr.indices]
                y64 = np.bincount(rows, weights=a * xv, minlength=csr.shape[0])
                mag = np.bincount(rows, weights=np.abs(a * xv), minlength=csr.shape[0])
                check(y.shape == (csr.shape[0],) and np.all(np.isfinite(y)), f"{key}: bad answer")
                check(bool(np.all(np.abs(y - y64) <= 1e-5 * mag + 1e-30)),
                      f"{key}: served answer disagrees with the float64 CSR product")
                check(np.array_equal(y, plans[key].matvec(x).cpu().numpy()),
                      f"{key}: served answer is not bitwise equal to plan.matvec")
            st = eng.stats()
            log(f"[serving] overlap={overlap}: {len(sent)} requests in "
                + ", ".join(f"{k}: {st[k]['batches']} batches" for k in plans)
                + f"; {wall:.3f} s wall; all answers within the float64 bound and "
                  "bitwise equal to plan.matvec")
    launches = {
        "hbp_spmv_fused": hbp_spmv_fused.launches,
        "hbp_spmm_fused": hbp_spmm_fused.launches,
    }
    log(f"[serving] kernel launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")

    # --- 5. times on m4_kron16 ------------------------------------------------
    n_rows, n_cols = kron.shape
    A_csr = torch.sparse_csr_tensor(
        torch.as_tensor(kron.indptr, dtype=torch.int64),
        torch.as_tensor(kron.indices, dtype=torch.int64),
        torch.as_tensor(kron.data, dtype=torch.float32),
        size=kron.shape,
        check_invariants=True,
    ).to(dev)
    T, group, lane = dt.data.shape
    index_bytes = dt.colblock.nbytes + dt.run_start.nbytes + dt.run_rowgroup.nbytes
    stream_bytes = dt.data.nbytes + dt.cols.nbytes + index_bytes
    rows = {}
    for k in (1, 8, 128):
        X = torch.randn(n_cols, k, device=dev, generator=g)
        if k == 1:
            x = X[:, 0].contiguous()
            name = "hbp_spmv_fused"
            kern, plain = (lambda: hbp_spmv_fused(dt, x)), (lambda: hbp_spmv_fused_plain(dt, x))
            lib = lambda: A_csr @ x  # noqa: E731
        else:
            name = "hbp_spmm_fused"
            kern, plain = (lambda: hbp_spmm_fused(dt, X)), (lambda: hbp_spmm_fused_plain(dt, X))
            lib = lambda: A_csr @ X  # noqa: E731
        ms = timed_ms(kern, 20 if k < 128 else 10)
        plain_ms = timed_ms(plain, 3, warmup=1)
        library_ms = timed_ms(lib, 20 if k < 128 else 10)
        x_bytes, y_bytes = n_cols * k * 4, dt.n_rowgroups * group * k * 4
        bytes_bound = (stream_bytes + x_bytes + y_bytes) / peak_bw * 1e3
        ops_bound = 2.0 * T * group * lane * k / peak_flops * 1e3
        nnz_bound = max((kron.nnz * 8 + x_bytes + n_rows * k * 4) / peak_bw,
                        2.0 * kron.nnz * k / peak_flops) * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[("m4_kron16", k)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_bound, ops_bound),
            "bound_by": "bytes" if bytes_bound >= ops_bound else "operations",
            "library_ms": library_ms, "matrix": "m4_kron16", "k": k,
            "nnz_bound_ms": nnz_bound, "card": smi_line,
        }
        rows[k] = row
        log("[times] " + json.dumps(row))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    # the kernels line: SpMV at k=1, SpMM at the serving bucket k=8
    print(json.dumps({"kernels": [rows[1], rows[8]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
