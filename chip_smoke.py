#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and print ptxas's
   register / shared-memory / spill lines;
3. kernels  — each of the six kernels against its plain PyTorch version on
   ``m4_kron16`` (65,536 rows, the size of SuiteSparse ``kron_g500-logn16``,
   tuned geometry), ``m10_ohne2`` (lane 128 pinned) and the hub-run matrix
   of ``tests/hub_runs.py`` (runs of more than 4 * ``RUN_CHUNK``, exactly
   ``RUN_CHUNK`` and ``RUN_CHUNK + 1`` tiles, lane 8) at k = 1, 8, 128,
   256, with the fused kernels' chunk index statistics: sums within
   ``rtol=1e-5, atol=1e-5 * max(1, |y_plain|_inf)``,
   maxima exactly.  The bitwise invariants: SpMV equals the SpMM column
   (k = 1, 8, 128 and under bucket padding) under ``"fused"`` and
   ``"partials"``, and for the partials kernels on their scalar-column
   path too (k = 3, 129, and k = 128 with x offset by one float);
   ``grid`` equals ``loop`` at k = 256; ``"stable"`` is
   batch-width invariant; the max monoid gives one answer under
   ``"fused"``, ``"partials"`` and ``"stable"``, equal to a numpy f32 max
   of ``a * x`` over each row's stored entries on sampled columns.  Row
   groups without tiles come out 0 (sum and max, every matrix) and an
   all-negative row stays negative under max.  NaN under max: with NaN in
   x rows that live slots read (and in rows only padded slots read) on
   ``m4_kron16``, the hub-run matrix and a matrix whose block-start
   columns are empty, kernels 3-4 and the partials combine put NaN exactly
   where their plain versions do (the rest bitwise), both entry points
   agree with ``"stable"``, and the padding-only NaN changes nothing;
4. serving  — ``MatrixRegistry(device="cuda")`` admits ``m4_kron16`` with
   the heuristic geometry and ``m1_asic320k`` with a measured search
   (CUDA-event probe); ``ServingEngine`` serves mixed k = 1..16 traffic
   over both, synchronous and overlapped.  Every answer is checked against
   a float64 CSR product (``|y - y64| <= 1e-5 * (|A| |x|) + 1e-30``) and
   bitwise against ``plan.matvec``; the fused SpMV/SpMM kernels' launch
   counters must have risen during this phase;
5. partials — the same with ``MatrixRegistry(device="cuda",
   strategy="partials")`` (the measured search with the partials probe);
   the partials SpMV/SpMM kernels' launch counters must rise;
6. graph    — GraphSAGE and GCN at the widths of the OGB ``ogbn-arxiv``
   GraphSAGE baseline (128 input features, 3 layers, hidden 256, 40
   classes; random weights from a seed) over
   ``rmat_graph(1 << 16, 79.345703125, seed=4)`` (65,536 nodes, the
   ``m4_kron16`` structure with unit weights), served through
   ``plan_aggregator`` under ``"fused"`` and ``"partials"``: SAGE-max,
   SAGE-mean and GCN over ``normalize_adjacency(add_self_loops(A),
   "sym")``.  Every aggregation output is checked (sum and mean against a
   float64 CSR product within ``1e-5 * (|A| |x|)``, max exactly against
   ``"stable"`` and against numpy on sampled columns); the logits of the
   two strategies agree within ``rtol=1e-4, atol=1e-4 * max(1,
   |logits|_inf)``; the max kernels' launch counters must rise;
7. times    — CUDA-event times of each kernel, its plain version and, for
   the sum kernels, the ``torch.sparse_csr_tensor`` product (a yardstick
   the port never calls) on ``m4_kron16`` (the partials SpMM and both max
   kernels also at the GNN hidden width k = 256), and of the fused SpMV
   and SpMM on ``m10_ohne2`` at k = 1 and 8, beside the least time the
   card could take for the kernel's own work (``kernel_bytes``: the
   partials kernels read tiles and x and write the per-tile partials; the
   fused kernels read tiles, run index and x and write y), and for the
   fused kernels the traffic of their chunk buffer beside it.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""
import importlib
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

SOURCES = {
    "hbp_spmv": "src/repro_torch/kernels/csrc/hbp_spmv.cu",
    "hbp_partials": "src/repro_torch/kernels/csrc/hbp_partials.cu",
}
# kernel -> (source, line of the TPU kernel's pl.pallas_call)
KERNELS = {
    "hbp_spmv_fused": ("hbp_spmv", "src/repro/kernels/hbp_spmv.py:139"),
    "hbp_spmm_fused": ("hbp_spmv", "src/repro/kernels/hbp_spmv.py:202"),
    "hbp_spmm_fused_max": ("hbp_spmv", "src/repro/kernels/hbp_spmv.py:264"),
    "hbp_spmm_partials_max": ("hbp_partials", "src/repro/kernels/hbp_spmv.py:306"),
    "hbp_spmv_partials": ("hbp_partials", "src/repro/kernels/hbp_spmv.py:344"),
    "hbp_spmm_partials": ("hbp_partials", "src/repro/kernels/hbp_spmv.py:385"),
}
RTOL = 1e-5
LOGIT_RTOL = 1e-4
# GraphSAGE baseline of OGB ogbn-arxiv (examples/nodeproppred/arxiv/gnn.py)
GNN_DIMS = [128, 256, 256, 40]


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


def kernel_bytes(name: str, d, k: int) -> int:
    """Bytes kernel ``name`` must move on staged tiles ``d`` at width ``k``:
    each input read once, each output written once, as the TPU function
    does.  The partials kernels read the tiles and x and write one
    ``[T, group, k]`` block; the fused kernels read the tiles, the run
    index and x and write y.  The fused kernels' own intermediates (the
    chunk index and the split runs' chunk buffer) are not the function's
    work and stay out of the bound."""
    T, group, _ = d.data.shape
    moved = d.data.nbytes + d.cols.nbytes + d.colblock.nbytes + d.shape[1] * k * 4
    if "partials" in name:
        return moved + T * group * k * 4
    return moved + d.run_start.nbytes + d.run_rowgroup.nbytes + d.n_rowgroups * group * k * 4


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


def exactly(y, y_plain, what: str) -> float:
    check(torch.equal(y, y_plain), f"{what}: max kernel is not exactly its plain version")
    return 0.0


def numpy_max_columns(csr, X: np.ndarray, cols) -> np.ndarray:
    """f32 max of ``a * x`` over each row's stored nonzeros, columns ``cols``
    of ``X``; 0 for rows with none (the served values are the f32 ``a``)."""
    a = csr.data.astype(np.float32)
    starts = csr.indptr[:-1]
    nonempty = np.diff(csr.indptr) > 0
    out = np.zeros((csr.shape[0], len(cols)), np.float32)
    for j, c in enumerate(cols):
        prod = np.where(a != 0, a * X[csr.indices, c], np.float32(-np.inf))
        m = np.full(csr.shape[0], -np.inf, np.float32)
        m[nonempty] = np.maximum.reduceat(prod, starts[nonempty])
        out[:, j] = np.where(np.isneginf(m), 0.0, m)
    return out


class Float64Csr:
    """``A`` and ``|A|`` in float64 on the card (the values as served, f32):
    the reference a sum or mean aggregation is held against."""

    def __init__(self, csr, dev):
        vals = torch.as_tensor(csr.data.astype(np.float32).astype(np.float64))
        idx = (torch.as_tensor(csr.indptr, dtype=torch.int64),
               torch.as_tensor(csr.indices, dtype=torch.int64))
        self.A = torch.sparse_csr_tensor(*idx, vals, size=csr.shape).to(dev)
        self.absA = torch.sparse_csr_tensor(*idx, vals.abs(), size=csr.shape).to(dev)
        self.div = torch.as_tensor(np.maximum(np.diff(csr.indptr), 1), dtype=torch.float64,
                                   device=dev)[:, None]

    def check(self, y, x, what: str, mean: bool = False) -> None:
        xd = x.double()
        y64, mag = self.A @ xd, self.absA @ xd.abs()
        if mean:
            y64, mag = y64 / self.div, mag / self.div
        check(bool(torch.all((y.double() - y64).abs() <= RTOL * mag + 1e-30)),
              f"{what}: disagrees with the float64 CSR product")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.core import COOMatrix, PartitionConfig, build_tiles, csr_from_coo
    from repro_torch.core import csr_from_dense, enumerate_configs, tuned_partition_config
    from repro_torch.core.matrices import SUITE_SPECS
    from repro_torch.graph import (
        GCN,
        GraphSAGE,
        add_self_loops,
        normalize_adjacency,
        plan_aggregator,
        rmat_graph,
    )
    from repro_torch.kernels import build, ops, ref

    # the kernels' module (``repro_torch.kernels.hbp_spmv`` is also the name
    # of the ops entry point, which an attribute import would return)
    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    from repro_torch.serving import MatrixRegistry, QoSClass, ServingEngine

    sys.path.insert(0, str(ROOT / "tests"))
    from hub_runs import hub_config, hub_coo

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    wrappers = {name: getattr(K, name) for name in KERNELS}
    plains = {name: getattr(K, name + "_plain") for name in KERNELS}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts(names):
        return {name: wrappers[name].launches for name in names}

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
    ohne = SUITE_SPECS["m10_ohne2"](0)
    ohne_cfg = PartitionConfig(lane=128)
    dt_ohne = ops.device_tiles(build_tiles(ohne, ohne_cfg), dev)
    hub = csr_from_coo(COOMatrix(*hub_coo(ops.RUN_CHUNK, 8)))
    dt_hub = ops.device_tiles(build_tiles(hub, PartitionConfig(**hub_config(8))), dev)
    matrices = (("m4_kron16", dt, kron), ("m10_ohne2", dt_ohne, ohne), ("hub", dt_hub, hub))
    # the fused kernels (sum and max) walk chunks of at most RUN_CHUNK
    # tiles of a row-group run, and fold the chunks of longer runs
    for label, d, _ in matrices:
        run_len = np.diff(d.run_start.cpu().numpy())
        chain = np.diff(d.chunk_start.cpu().numpy())
        log(f"[kernels] {label} runs={run_len.size} tiles/run mean={run_len.mean():.1f} "
            f"max={run_len.max()}; RUN_CHUNK={ops.RUN_CHUNK} chunks={chain.size} "
            f"split runs={d.split_run.numel()} ({d.n_split_chunks} chunks, folded by the fused "
            f"sum and the fused max) longest chain={chain.max()} tiles; chunk buffer "
            f"{d.chunk_buffer_nbytes(8)} B at k=8, {d.chunk_buffer_nbytes(128)} B at k=128, "
            f"{d.chunk_buffer_nbytes(256)} B at k=256")
    check({ops.RUN_CHUNK, ops.RUN_CHUNK + 1} <= set(np.diff(dt_hub.run_start.cpu().numpy()))
          and dt_hub.n_split_chunks > 0, "the hub matrix lacks the runs it promises")

    errs = {}  # (kernel, matrix, k) -> max abs err against the plain version
    for label, d, csr in matrices:
        x = torch.randn(d.shape[1], device=dev, generator=g)
        y = K.hbp_spmv_fused(d, x)
        errs["hbp_spmv_fused", label, 1] = max_err_within(
            y, K.hbp_spmv_fused_plain(d, x), f"{label} fused spmv")
        p = K.hbp_spmv_partials(d, x)
        errs["hbp_spmv_partials", label, 1] = max_err_within(
            p, K.hbp_spmv_partials_plain(d, x), f"{label} partials spmv")
        empty = torch.as_tensor(
            np.setdiff1d(np.arange(d.n_rowgroups), d.run_rowgroup.cpu().numpy()), device=dev)
        check(bool(torch.all(y[empty] == 0)), f"{label}: empty row groups are not zero (spmv)")
        for k in (1, 8, 128, 256):
            X = torch.randn(d.shape[1], k, device=dev, generator=g)
            c = k // 2
            X[:, c] = x
            for name in ("hbp_spmm_fused", "hbp_spmm_partials"):
                Y = wrappers[name](d, X)
                errs[name, label, k] = max_err_within(
                    Y, plains[name](d, X), f"{label} {name} k={k}")
                check(torch.equal(Y[..., c], y if name == "hbp_spmm_fused" else p),
                      f"{label} {name}: SpMV != SpMM column at k={k}")
            for name in ("hbp_spmm_fused_max", "hbp_spmm_partials_max"):
                errs[name, label, k] = exactly(wrappers[name](d, X), plains[name](d, X),
                                               f"{label} {name} k={k}")
        # the partials sum kernels' scalar-column path: k not a multiple of
        # 4, and an x whose storage starts one float past a 16-byte boundary
        for k, offset in ((3, False), (129, False), (128, True)):
            X = torch.randn(d.shape[1], k, device=dev, generator=g)
            X[:, k // 2] = x
            if offset:
                X = torch.empty(X.numel() + 1, device=dev)[1:].view(X.shape).copy_(X)
                check(X.data_ptr() % 16 != 0, "the offset x is 16-byte aligned")
            P = K.hbp_spmm_partials(d, X)
            max_err_within(P, K.hbp_spmm_partials_plain(d, X),
                           f"{label} hbp_spmm_partials k={k} offset={offset}")
            check(torch.equal(P[..., k // 2], p),
                  f"{label} hbp_spmm_partials: SpMV != SpMM column at k={k} offset={offset}")
        # through the entry points: bucket padding (5 -> 8), k tiling, and
        # the max monoid on every strategy against numpy
        X5 = torch.randn(d.shape[1], 5, device=dev, generator=g)
        X5[:, 3] = x
        X256 = torch.randn(d.shape[1], 256, device=dev, generator=g)
        for strategy in ("fused", "partials"):
            y_served = ops.hbp_spmv(d, x, strategy=strategy)
            check(torch.equal(ops.hbp_spmm_bucketed(d, X5, strategy=strategy)[:, 3], y_served),
                  f"{label} {strategy}: bucket-padded column != SpMV")
            for combine in ("sum", "max"):
                kw = dict(strategy=strategy, combine=combine)
                check(torch.equal(ops.hbp_spmm(d, X256, k_tiling="grid", **kw),
                                  ops.hbp_spmm(d, X256, k_tiling="loop", **kw)),
                      f"{label} {strategy} {combine}: k=256 grid != loop")
        Xn = X256.cpu().numpy()
        sampled = (0, 77, 255)
        want = numpy_max_columns(csr, Xn, sampled)
        y_max = {s: ops.hbp_spmm(d, X256, strategy=s, combine="max")
                 for s in ("fused", "partials", "stable")}
        for s, ym in y_max.items():
            check(torch.equal(ym, y_max["stable"]), f"{label}: max under {s} != stable")
            check(np.array_equal(ym[:, list(sampled)].cpu().numpy(), want),
                  f"{label}: max under {s} != numpy on sampled columns")
        del y_max, X256
        log(f"[kernels] {label}: max abs err vs plain "
            + ", ".join(f"{n} k={k}: {e:.3e}" for (n, lab, k), e in errs.items()
                        if lab == label and not n.endswith("_max"))
            + "; max kernels exactly plain at k=1, 8, 128, 256; bitwise SpMV == SpMM column "
              "(fused and partials, k=1, 8, 128, 256, bucket 5->8; partials on the "
              "scalar-column path at k=3, 129 and 128 with x offset by one float); "
              "grid == loop at k=256 "
              "(sum and max); max equal under fused/partials/stable and to numpy on columns "
            + str(list(sampled)) + f"; {empty.numel()} empty row groups are 0")
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
    # row groups that own no tiles come out exactly 0; an all-negative row
    # stays negative under max (the -inf masking, not a 0 from padding)
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((4096, 3000)) * (rng.random((4096, 3000)) < 0.01)
    dense[512:2560] = 0.0
    dense[100] = -np.abs(dense[100])
    dense[100, :4] = -1.5
    holes_csr = csr_from_dense(dense)
    holes = build_tiles(holes_csr, PartitionConfig(lane=8))
    empty = np.setdiff1d(np.arange(holes.n_rowgroups), holes.rowgroup)
    check(empty.size > 0, "the empty-row matrix has no empty row group")
    dh = ops.device_tiles(holes, dev)
    empty_t = torch.as_tensor(empty, device=dev)
    Xh = torch.randn(3000, 8, device=dev, generator=g)
    Xh[:, 0] = Xh[:, 0].abs() + 0.1  # every product of row 100 is negative here
    check(bool(torch.all(K.hbp_spmm_fused(dh, Xh)[empty_t] == 0)),
          "empty row groups are not zero (spmm)")
    check(bool(torch.all(K.hbp_spmv_fused(dh, Xh[:, 0].contiguous())[empty_t] == 0)),
          "empty row groups are not zero (spmv)")
    want_h = numpy_max_columns(holes_csr, Xh.cpu().numpy(), range(8))
    for strategy in ("fused", "partials"):
        Yh = ops.hbp_spmm(dh, Xh, strategy=strategy)
        check(bool(torch.all(Yh[512:2560] == 0)), f"{strategy}: empty rows are not zero")
        Ym = ops.hbp_spmm(dh, Xh, strategy=strategy, combine="max")
        check(bool(torch.all(Ym[512:2560] == 0)), f"{strategy}: empty rows are not zero (max)")
        check(float(Ym[100, 0]) < 0, f"{strategy}: the all-negative row lost its sign (max)")
        check(np.array_equal(Ym.cpu().numpy(), want_h), f"{strategy}: max != numpy")
    kron_empty = kron_tiles.n_rowgroups - len(np.unique(kron_tiles.rowgroup))
    log(f"[kernels] empty row groups are 0 (sum and max, fused and partials): {empty.size} of "
        f"{holes.n_rowgroups} (synthetic), m4_kron16 has {kron_empty}; the all-negative row "
        f"stays negative under max ({float(Ym[100, 0]):.4f})")

    # NaN under the max monoid: a NaN in x that a live slot reads makes its
    # output NaN (jnp.max in the JAX package); one that only padded slots
    # read changes nothing (the first column of each block of ``pads``
    # holds no entry).  Kernels 3-4 against their plain versions, the
    # partials combine, and both entry points against "stable": NaN in the
    # same places, every other element bitwise equal.
    def same_bits(y, y_plain, what):
        nan = torch.isnan(y_plain)
        check(torch.equal(torch.isnan(y), nan)
              and torch.equal(y[~nan].view(torch.int32), y_plain[~nan].view(torch.int32)),
              f"{what}: NaN positions or bits differ")

    pads_dense = dense.copy()
    pads_cfg = PartitionConfig(lane=8)
    pads_dense[:, ::pads_cfg.col_block] = 0.0
    pads = build_tiles(csr_from_dense(pads_dense), pads_cfg)
    nan_cases = (("m4_kron16", dt, (8, 256)), ("hub", dt_hub, (1, 8, 128)),
                 ("pads", ops.device_tiles(pads, dev), (1, 8, 128)))
    nan_rng = np.random.default_rng(5)
    for label, d, widths in nan_cases:
        data, cols = d.data.cpu().numpy(), d.cols.cpu().numpy()
        x_row = d.colblock.cpu().numpy()[:, None, None].astype(np.int64) * d.col_block + cols
        live = np.unique(x_row[data != 0])
        padding_only = torch.as_tensor(np.setdiff1d(np.unique(x_row[data == 0]), live),
                                       device=dev)
        check(label != "pads" or padding_only.numel() > 0, "pads: no x row read by padding only")
        n_nan = []
        for k in widths:
            X = torch.randn(d.shape[1], k, device=dev, generator=g)
            X[torch.as_tensor(nan_rng.choice(live, 3, replace=False), device=dev)] = float("nan")
            X[padding_only] = float("nan")
            Yf, P = K.hbp_spmm_fused_max(d, X), K.hbp_spmm_partials_max(d, X)
            check(bool(torch.isnan(Yf).any()), f"{label} k={k}: no NaN reached y")
            same_bits(Yf, K.hbp_spmm_fused_max_plain(d, X), f"{label} fused max k={k}")
            same_bits(P, K.hbp_spmm_partials_max_plain(d, X), f"{label} partials max k={k}")
            combined = ref.segment_max_sorted(P, d.rowgroup, d.n_rowgroups, d.rg_lengths)
            same_bits(combined, Yf, f"{label} partials combine k={k}")
            stable = ops.hbp_spmm(d, X, strategy="stable", combine="max")
            for strategy in ("fused", "partials"):
                same_bits(ops.hbp_spmm(d, X, strategy=strategy, combine="max"), stable,
                          f"{label} {strategy} entry k={k}")
            X[padding_only] = 0.0
            same_bits(K.hbp_spmm_fused_max(d, X), Yf, f"{label} fused max, padding-only NaN")
            same_bits(K.hbp_spmm_partials_max(d, X), P, f"{label} partials max, padding-only NaN")
            n_nan.append(int(torch.isnan(stable).sum()))
        log(f"[kernels] NaN: {label} at k={list(widths)}: {n_nan} NaN outputs, kernels 3-4 and "
            f"the partials combine carry them exactly as the plain versions, both entry points "
            f"as stable; NaN in {padding_only.numel()} x rows read only by padded slots changed "
            "nothing")

    # --- 4./5. serving: the fused and the partials registry ---------------
    asic = SUITE_SPECS["m1_asic320k"](0)
    candidates = enumerate_configs(
        asic.shape, row_blocks=(512,), col_blocks=(4096,), lanes=(8, 16, 32)
    )
    csrs = {"m4_kron16": kron, "m1_asic320k": asic}
    served_ref = {}  # per matrix: row of each entry, entry values as served (f32)
    for key, csr in csrs.items():
        served_ref[key] = (np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr)),
                    csr.data.astype(np.float32).astype(np.float64))
    launches = {}  # kernel -> launches in the phase that drives its path

    def serve_phase(tag: str, cache: str, strategy, kernels) -> None:
        reset_counts()
        registry = MatrixRegistry(device="cuda", cache_dir=cache, candidates=candidates,
                                  strategy=strategy)
        check(registry.strategy == (strategy or "fused"),
              f"strategy on the card is {registry.strategy}")
        registry.search = False  # kron16: the nnz-profile heuristic
        plan_k = registry.admit(kron, "m4_kron16")
        registry.search = True  # asic: measured search with the CUDA-event probe
        plan_a = registry.admit(asic, "m1_asic320k")
        check(plan_a.autotune_searched and len(plan_a.provenance["trials"]) == len(candidates),
              "the measured search did not run")
        log(f"[{tag}] admitted m4_kron16 cfg={plan_k.cfg} in {plan_k.preprocess_s:.1f} s; "
            f"m1_asic320k searched {len(candidates)} geometries in {plan_a.preprocess_s:.1f} s: "
            + ", ".join(f"lane {t['config']['lane']}: {t['objective_us']} us"
                        for t in plan_a.provenance["trials"]))
        plans = {"m4_kron16": plan_k, "m1_asic320k": plan_a}
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
                rows, a = served_ref[key]
                xv = x.astype(np.float64)[csr.indices]
                y64 = np.bincount(rows, weights=a * xv, minlength=csr.shape[0])
                mag = np.bincount(rows, weights=np.abs(a * xv), minlength=csr.shape[0])
                check(y.shape == (csr.shape[0],) and np.all(np.isfinite(y)), f"{key}: bad answer")
                check(bool(np.all(np.abs(y - y64) <= 1e-5 * mag + 1e-30)),
                      f"{key}: served answer disagrees with the float64 CSR product")
                check(np.array_equal(y, plans[key].matvec(x).cpu().numpy()),
                      f"{key}: served answer is not bitwise equal to plan.matvec")
            st = eng.stats()
            log(f"[{tag}] overlap={overlap}: {len(sent)} requests in "
                + ", ".join(f"{k}: {st[k]['batches']} batches, compute {st[k]['compute_s']:.4f} s, "
                            f"latency p99 {st[k]['latency_p99_s']:.4f} s" for k in plans)
                + f"; {wall:.3f} s wall; all answers within the float64 bound and "
                  "bitwise equal to plan.matvec")
        counts = read_counts(kernels)
        log(f"[{tag}] kernel launches on this path: {read_counts(KERNELS)}")
        for name, n in counts.items():
            check(n > 0, f"{name} was never launched on the {tag} path")
        launches.update(counts)

    with tempfile.TemporaryDirectory() as cache:
        # flight-recorder dumps (if a latency anomaly fires) stay out of the tree
        os.environ["REPRO_FLIGHT_DIR"] = cache
        serve_phase("serving", cache, None, ("hbp_spmv_fused", "hbp_spmm_fused"))
        serve_phase("partials", cache, "partials", ("hbp_spmv_partials", "hbp_spmm_partials"))

        # --- 6. graph: GraphSAGE and GCN forwards at full width -------------
        t0 = time.perf_counter()
        A = rmat_graph(1 << 16, 79.345703125, seed=4)
        A_hat = normalize_adjacency(add_self_loops(A), "sym")
        log(f"[graph] A {A.shape} nnz={A.nnz}, A_hat nnz={A_hat.nnz}, built in "
            f"{time.perf_counter() - t0:.1f} s")
        ref64 = {"A": Float64Csr(A, dev), "A_hat": Float64Csr(A_hat, dev)}
        graphs = {"A": A, "A_hat": A_hat}
        reset_counts()
        plans = {}
        for strategy in ("fused", "partials"):
            reg = MatrixRegistry(device="cuda", cache_dir=cache, search=False, strategy=strategy)
            for gname, csr in graphs.items():
                plans[strategy, gname] = plan = reg.admit(csr, gname)
                log(f"[graph] {strategy}: admitted {gname} cfg={plan.cfg} "
                    f"tiles={plan.tiles.n_tiles} in {plan.preprocess_s:.1f} s")
        gx = torch.Generator(device=dev).manual_seed(5)
        feats = torch.randn(A.shape[0], GNN_DIMS[0], device=dev, generator=gx)
        models = {
            "sage": GraphSAGE(GNN_DIMS, generator=torch.Generator(device=dev).manual_seed(6),
                              device=dev),
            "gcn": GCN(GNN_DIMS, generator=torch.Generator(device=dev).manual_seed(7), device=dev),
        }
        # (model, aggregation, graph) of each forward
        forwards = {
            "sage-max": ("sage", "max", "A"),
            "sage-mean": ("sage", "mean", "A"),
            "gcn": ("gcn", "sum", "A_hat"),
        }
        widths = set()

        def checked(strategy, op, gname):
            plan = plans[strategy, gname]
            agg = plan_aggregator(plan, op=op)

            def f(x):
                y = agg(x)
                what = f"{strategy} {op} over {gname} at k={x.shape[1]}"
                widths.add(x.shape[1])
                check(y.shape == x.shape and bool(torch.all(torch.isfinite(y))),
                      f"{what}: bad output")
                if op == "max":
                    stable = ops.hbp_spmm(plan.device, x, strategy="stable", combine="max")
                    check(torch.equal(y, stable), f"{what}: != stable")
                    cols = (0, x.shape[1] // 2, x.shape[1] - 1)
                    want = numpy_max_columns(graphs[gname], x.cpu().numpy(), cols)
                    check(np.array_equal(y[:, list(cols)].cpu().numpy(), want),
                          f"{what}: != numpy on sampled columns")
                else:
                    ref64[gname].check(y, x, what, mean=op == "mean")
                return y

            return f

        logits = {}
        fwd_ms = {}
        with torch.inference_mode():
            for fname, (mname, op, gname) in forwards.items():
                for strategy in ("fused", "partials"):
                    out = models[mname](checked(strategy, op, gname), feats)
                    check(out.shape == (A.shape[0], GNN_DIMS[-1])
                          and bool(torch.all(torch.isfinite(out))), f"{fname}: bad logits")
                    logits[fname, strategy] = out
                    agg = plan_aggregator(plans[strategy, gname], op=op)
                    fwd_ms[fname, strategy] = timed_ms(lambda: models[mname](agg, feats), 3, 1)
                a, b = logits[fname, "fused"], logits[fname, "partials"]
                diff = (a - b).abs().max().item()
                tol = LOGIT_RTOL * max(1.0, a.abs().max().item())
                check(bool(torch.all((a - b).abs() <= LOGIT_RTOL * a.abs() + tol)),
                      f"{fname}: fused and partials logits disagree (max abs diff {diff:.3e})")
                log(f"[graph] {fname}: logits [{out.shape[0]}, {out.shape[1]}], "
                    f"|logits|_inf={a.abs().max().item():.4f}, fused vs partials max abs diff "
                    f"{diff:.3e}; ms per 3-layer forward: fused "
                    f"{fwd_ms[fname, 'fused']:.3f}, partials {fwd_ms[fname, 'partials']:.3f}")
        check({128, 256, 40} <= widths, f"aggregation widths {sorted(widths)}")
        counts = read_counts(KERNELS)
        log(f"[graph] every aggregation within its bound (sum/mean) or exact (max) at widths "
            f"{sorted(widths)}; kernel launches on this path: {counts}")
        for name in ("hbp_spmm_fused_max", "hbp_spmm_partials_max"):
            check(counts[name] > 0, f"{name} was never launched on the graph path")
            launches[name] = counts[name]
        del plans, logits, ref64

    # --- 7. times on m4_kron16 (and the fused sum on m10_ohne2) --------------
    def csr_tensor(csr):
        return torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data, dtype=torch.float32),
            size=csr.shape,
            check_invariants=True,
        ).to(dev)

    timed = {"m4_kron16": (kron, dt, csr_tensor(kron)),
             "m10_ohne2": (ohne, dt_ohne, csr_tensor(ohne))}
    rows = {}
    cases = [("m4_kron16", "hbp_spmv_fused", 1), ("m4_kron16", "hbp_spmv_partials", 1)] + [
        ("m4_kron16", name, k) for k in (8, 128) for name in
        ("hbp_spmm_fused", "hbp_spmm_partials", "hbp_spmm_fused_max", "hbp_spmm_partials_max")
    ] + [("m4_kron16", name, 256)  # the GCN/SAGE hidden width
         for name in ("hbp_spmm_partials", "hbp_spmm_fused_max", "hbp_spmm_partials_max")] + [
        ("m10_ohne2", "hbp_spmv_fused", 1), ("m10_ohne2", "hbp_spmm_fused", 8)]
    for label, name, k in cases:
        csr, d, A_csr = timed[label]
        n_rows, n_cols = csr.shape
        X = torch.randn(n_cols, k, device=dev, generator=g)
        arg = X[:, 0].contiguous() if k == 1 else X
        kern, plain = wrappers[name], plains[name]
        ms = timed_ms(lambda: kern(d, arg), 20 if k < 128 else 10)
        plain_ms = timed_ms(lambda: plain(d, arg), 3, warmup=1)
        # no PyTorch call computes a max-monoid SpMM on CUDA
        # (torch.sparse.mm(reduce="amax") runs on the CPU only)
        library_ms = None if name.endswith("_max") else timed_ms(lambda: A_csr @ arg, 20)
        x_bytes = n_cols * k * 4
        bytes_bound = kernel_bytes(name, d, k) / peak_bw * 1e3
        # a multiply and an add (or max) per stored entry and column: what
        # this data needs, padded slots not counted
        ops_bound = 2.0 * csr.nnz * k / peak_flops * 1e3
        nnz_bound = max((csr.nnz * 8 + x_bytes + n_rows * k * 4) / peak_bw,
                        2.0 * csr.nnz * k / peak_flops) * 1e3
        source, replaces = KERNELS[name]
        row = {
            "name": name, "route": "cuda", "source": SOURCES[source], "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name, label, k],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_bound, ops_bound),
            "bound_by": "bytes" if bytes_bound >= ops_bound else "operations",
            "library_ms": library_ms, "matrix": label, "k": k,
            "nnz_bound_ms": nnz_bound, "card": smi_line,
        }
        if "fused" in name:
            # the split runs' chunk partials, written by the chains and
            # read back by the fold (beside bound_ms, not in it)
            buf = 2 * d.chunk_buffer_nbytes(k)
            row["chunk_buffer_bytes"] = buf
            row["chunk_buffer_ms"] = buf / peak_bw * 1e3
        if "partials" in name:
            # the combine's time: it reads the partials back
            contrib = kern(d, arg)
            combine = ref.segment_max_sorted if name.endswith("_max") else ref.segment_sum_sorted
            view = contrib[..., None] if k == 1 else contrib
            row["combine_ms"] = timed_ms(
                lambda: combine(view, d.rowgroup, d.n_rowgroups, d.rg_lengths), 10)
        # the whole entry point: kernel, combine, -inf mapping and unpermute
        kw = dict(strategy="partials" if "partials" in name else "fused")
        if k == 1:
            entry = lambda: ops.hbp_spmv(d, arg, **kw)  # noqa: E731
        else:
            kw["combine"] = "max" if name.endswith("_max") else "sum"
            entry = lambda: ops.hbp_spmm(d, arg, **kw)  # noqa: E731
        row["entry_ms"] = timed_ms(entry, 10)
        rows[name, label, k] = row
        log("[times] " + json.dumps(row))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    # the kernels line: the SpMV kernels at k=1, the sum SpMM kernels at the
    # serving bucket k=8, the max kernels at the graph width k=128
    line = [rows[name, "m4_kron16", k] for name, k in (
        ("hbp_spmv_fused", 1), ("hbp_spmm_fused", 8), ("hbp_spmm_fused_max", 128),
        ("hbp_spmm_partials_max", 128), ("hbp_spmv_partials", 1), ("hbp_spmm_partials", 8))]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
