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
   ``"stable"`` is
   batch-width invariant; the max monoid gives one answer under
   ``"fused"``, ``"partials"`` and ``"stable"``, equal to a numpy f32 max
   of ``a * x`` over each row's stored entries on sampled columns.  Row
   groups without tiles come out 0 (sum and max, every matrix) and an
   all-negative row stays negative under max.  NaN under max: with NaN in
   x rows that live slots read (and in rows only padded slots read) on
   ``m4_kron16``, the hub-run matrix and a matrix whose block-start
   columns are empty, kernels 3-4 and the partials combine (plain, and the
   combine kernel of kernel 4's ``runs=True`` launch call, the partials max
   entry point's path) put NaN exactly where their plain versions do (the rest bitwise), both entry points
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
   the sum kernels, the ``torch.sparse_csr_tensor`` product (a yardstick;
   the port calls it only as its front door's CSR baseline) on ``m4_kron16`` (the partials SpMM and both max
   kernels also at the GNN hidden width k = 256), and of the fused SpMV
   and SpMM on ``m10_ohne2`` at k = 1 and 8, beside the least time the
   card could take for the kernel's own work (``kernel_bytes``: the
   partials kernels read tiles and x and write the per-tile partials; the
   fused kernels read tiles, run index and x and write y), and for the
   fused kernels the traffic of their chunk buffer beside it; for the
   partials max also kernel 4 with its run combine (``runs_ms``) beside
   the plain combine it replaces (``plain_combine_ms``); and the argmax
   kernel on ``m4_kron16`` at k = 8, 128 and 256, bitwise its plain
   version, beside kernel 3 on the same tiles and x (``fused_max_ms``:
   what the payload costs over the plain max), the torch lane chain it
   replaced (``plain_ms``) and its bound (three outputs written); and
   GAT's SDDMM kernel (:func:`sddmm_times_rows`) on ``A + I`` of the
   graph phase's ``A`` at the ogbn-arxiv GAT's 3 heads of C = 250 and 40,
   within ``1e-5 * |want| + 1e-5 * sqrt(C)`` of a float64 ``ref.sddmm``,
   beside its plain version, ``torch.sparse.sampled_addmm`` on a batched
   CSR (the heads as the batch: cuSPARSE's SDDMM, a yardstick the port
   does not call) and ``h100bench/work/gat.py``'s bound; and GAT's edge
   softmax kernels (:func:`softmax_times_rows`) on the same ``A + I`` at 3
   heads, forward and backward (its row and column launches), against
   float64 plain versions, beside the plain versions on the card (the torch
   segment passes they replaced) and ``softmax()``'s bound;

and, run after phase 2 (mesh), after phase 3 (zero, spmv), after phase 5
(telemetry, distributed) and after phase 6 (train, solvers, lm, lm-train,
dryrun):

* zero     — the signed-zero probe of ``tests/hub_runs.py`` (x = +0 and
  -0, so every product is a zero): kernels 3-4, their plain versions, the
  run combine and the fused, partials and stable entry points rank
  ``+0.0`` above ``-0.0`` (IEEE's maximum, as ``jnp.maximum``) in lane
  order, tile order and across a split run's chunks, compared as bit
  patterns;
* spmv     — the front door ``repro_torch.core.spmv`` / ``spmm`` on
  ``m4_kron16`` as a ``CSRMatrix`` (torch's sparse-CSR product, cuSPARSE)
  and as ``HBPTiles`` (the fused kernels), within ``1e-5 * (|A| |x|)`` of
  a float64 CSR product, the ``[n, 1]`` shape kept;
* train    — GNN training at the same ``ogbn-arxiv`` widths: GCN over
  ``A_hat`` (symmetric, so its registry pair self-links) and SAGE-mean /
  SAGE-max over ``rmat_graph(1 << 16, 79.345703125, seed=4,
  symmetric=False)`` (A and its transpose differ), admitted with
  ``admit_pair`` under ``"fused"`` and ``"partials"``.  Gradients: sum
  and mean ``x_bar`` within ``1e-5 * (|A^T| |y_bar|)`` of a float64
  ``A^T @ (y_bar / d)``, with kernel 2 (fused) or 6 (partials) launched
  during the backward alone; max: ``y``, ``idx``, ``coeff`` bitwise the
  CPU argmax on sampled columns and ``x_bar`` within ``(m + 1) * 2**-24 *
  sum|coeff * y_bar|`` of a float64 scatter (its atomic adds run in no
  fixed order).  ``fit``: 3 steps of each model under both strategies
  from the same weights, finite losses, the last below the first, the two
  strategies' histories within ``rtol=1e-3``; ``fit_sampled``: SAGE-mean,
  fanouts (10, 5), batch 1024, two epochs of four batches, the second
  admitting nothing.  Prints ms per train step (CUDA events), the argmax
  SpMM's ms at k = 128 and 256 and its share of a SAGE-max step, and
  ``torch.cuda.max_memory_allocated``;
* solvers  — ``repro_torch.solvers`` on the card under ``"fused"`` and
  ``"partials"``: CG at k = 1 and 8 (``tol=1e-5``) and Chebyshev (40
  steps, ``lam`` in [8/30, 8], within ``rtol=1e-4`` of the same run on the
  plain versions on the card) on the 5-point Laplacian of a 512 x 512
  grid (262,144 rows; cut from 1024 x 1024, see ``SOLVER_GRID``); CG at
  ``CHECK_EVERY`` = 1, 2, 4, 8, 16, 32, bit
  for bit the default's; Jacobi and block-Jacobi (hash-group blocks) PCG
  on ``D A D`` of a 512 x 512 grid, ``d`` log-uniform over [1e-2, 1e2]
  (fewer steps than CG without M; within 2 % of the plain versions' count);
  BiCGSTAB on ``m11_rajat21 + 1.5 max|a| I`` at k = 1 and 8, with and
  without Jacobi; PageRank (damping 0.85, ``tol=1e-8``) on the transition
  matrix of ``m4_kron16`` at k = 1 and 8, within 1e-5 (L1 per column) of
  the float64 recurrence (scipy.sparse) for the same step count; power
  iteration on ``rmat_graph(1 << 16, 79.345703125, seed=4)`` within 1e-4
  of ``eigsh``; and ``MatrixRegistry(probe=cg_probe(iters=10))`` admitting
  the 512 x 512 Laplacian by measured search (lanes 8/16/32), then
  ``cg(plan.operator(), b, M=plan.jacobi())``.  Every linear solve
  converges (Chebyshev: exactly 40 steps) and its float64 true residual
  stays under the recurrence's plus ``GAP_FLOOR_FACTOR`` times the f32
  floor; each prints its iterations, ms per solve and per iteration (CUDA
  events), host syncs (``set_sync_debug_mode("warn")``), kernel launches
  and the masked ones after convergence, and the HBP kernels' share of the
  solve and the device's busy share (``torch.profiler``); the launch
  counters must rise;
* telemetry — with ``repro_torch.obs`` enabled, ``MatrixRegistry`` /
  ``ServingEngine`` serve 62 requests (batch widths 1..16) on
  ``m4_kron16`` under ``"fused"`` and under ``"partials"`` (answers
  finite, the first and last bitwise ``plan.matvec``).  Prints the
  bandwidth attribution (achieved GB/s per matrix and strategy against the
  card's spec from ``repro_torch.analysis.roofline.spec_for``) and the
  explain report, which names the card's part; each row's launches must
  equal the rise of its two kernels' launch counters and its roofline
  fraction be at most 1.05 (more is a byte-count fault).  A
  ``MetricsServer`` on 127.0.0.1 (port 0) is scraped, and
  ``parse_openmetrics`` of the scrape must give the registry's ``attr.*``
  values; the two strategies' snapshots are diffed (``diff_artifacts``);
* distributed — ``repro_torch.core.distributed`` on ``m4_kron16`` under the
  ``balanced`` and ``grid`` placements: world 1 under NCCL in this process
  and, at the same time, world 2 under gloo in two spawned processes, both
  on ``cuda:0`` (NCCL takes one card per rank; gloo reduces CUDA tensors
  through the host).  Every rank's y must lie within ``1e-5 * (|A| |x|)``
  of a float64 CSR product, equal rank 0's and its own second call
  bitwise, and kernel 5 must launch twice on every rank; the children's
  exit codes are checked.  Prints the loads' max/mean, the shard build
  time, and per rank the matvec, kernel 5 and ``all_reduce`` times.

* lm       — the LM serving path (``examples/serve_pruned.py``'s
  counterpart) at the full width of OLMo-1B (16 layers, d_model 2048,
  16 heads x 128, d_ff 8192, vocab 50304, bf16, random weights from a
  seed): ``Engine(EngineConfig(batch=4, max_len=256))`` serves 8 requests
  of 12 prompt tokens and 16 new tokens each (the launcher's defaults),
  printing prefill ms and decode ms per step (CUDA events around the
  engine's steps) beside the decode bound (the bf16 weight bytes once over
  the card's bandwidth), tok/s and peak memory; on an f32 copy of the
  weights the prefill's and each cached decode step's logits equal a full
  forward over the same tokens within ``rtol=1e-4, atol=1e-4 *
  max|logits|``; the ``wg``, ``w1`` and ``w2`` of all 16 layers are pruned
  to 90 % and admitted as ``SparseLinear`` (48 layers, host build seconds
  printed), each held at k = 1, 4 and 48 against the pruned dense product
  and against its plain version (``backend="torch"`` on the card) within
  ``1e-5 * (|x| |W_pruned|^T)``, its k = 4 SpMM columns bit for bit the
  per-token SpMVs, and kernels 1-2 must launch; ``[lm-times]`` rows time
  ``SparseLinear.apply`` at k = 1 and 4 on one matrix of each shape beside
  its plain version, the dense bf16 and f32 products, the
  ``torch.sparse_csr_tensor`` product and the kernel's bytes bound.
* lm-train — LM training (``python -m repro_torch.launch.train``'s path)
  after the serving model is freed; no HBP kernel runs on it (the JAX
  package differentiates the dense model).  OLMo-1B at full width and
  depth in bf16 through ``Trainer``: 8 steps of
  ``SyntheticLM(vocab=50304, seq_len=1024, global_batch=8, seed=0)`` in
  two microbatches with remat (two-level: 4 x 4 groups), the launcher's
  AdamW defaults with f32 moments; prints ms per step (CUDA events, the
  median of steps 2-8), tokens/s, model TFLOP/s (6 N tokens plus the
  attention products, recomputation not counted), peak memory and the
  card's busy share of one profiled step, and checks every loss and grad
  norm finite, the last loss below the first and the per-layer AdamW
  update run on the three FFN stacks (3 leaves a step).  Then 2 steps with
  int8 moments (peak memory beside the f32 run's).  At 2 layers, full
  width, TF32 off and under ``torch.use_deterministic_algorithms``: one
  float32 step against the same step in float64 (loss within 1e-4, grad
  norm within 1e-3, and per leaf the rule of ``STEP_TOL``), ``remat=True``
  bit for bit ``remat=False``, two microbatches against one (``STEP_TOL``),
  and 6 steps straight bit for bit 3 steps, a checkpoint to a temporary
  directory and a resume in a fresh ``Trainer`` (an op without a
  deterministic CUDA implementation would be named, and the difference
  printed instead).

* dryrun   — ``repro_torch.launch.dryrun`` on the 1x1 host mesh (a
  ``DeviceMesh`` over a world-1 NCCL group), fake CUDA tensors, for the two
  OLMo-1B steps measured above: the train step at 8 x 1024 with
  ``[lm-train]``'s microbatches, remat and f32 moments, and the decode at
  batch 4 with ``[lm]``'s cache of 256.  Each predicted
  ``peak_estimate_bytes`` is printed beside that phase's
  ``torch.cuda.max_memory_allocated()`` less the bytes the earlier phases
  still held when it began, with their ratio, and must lie within
  ``DRYRUN_TOL`` (15 %) of it either way.  Then ``decode_32k`` of every
  arch on the ``single`` and ``multipod`` meshes (records in a temporary
  directory), none an error, and the ``fleet_stats`` line; the full sweep is ``python -m repro_torch.launch.dryrun --all
  --mesh both``.

* mesh     — (first, in a process of its own, started before the build,
  which runs beside it; its dry runs run while its ranks do) each model of
  ``MESH_MODELS`` trains on a ``(2, 2)`` ``("data", "model")`` mesh
  (``launch.mesh.make_mesh``) of 4 ranks spawned on ``cuda:0`` under gloo
  (a fresh ``file://`` rendezvous), ``TRAIN_RULES``: FSDP over ``data``,
  tensor parallelism over ``model``, expert parallelism over ``model``
  (each rank holds E / 2 experts of every MoE layer) and the SSM's inner
  channels and heads over ``model``, DTensors behind ``place``, ``shard``,
  ``constrain_defs``, ``param_shardings`` and ``make_global_batch(mesh=)``.
  The models: OLMo-1B (float32 at 4 of its 16 layers), granite-moe-1b-a400m
  (all 24 layers) and mamba2-370m (12 of its 48), each at full width.  In
  float32, 2 steps of ``SyntheticLM(vocab, seq_len=512, global_batch=8,
  seed=0)`` (512, not ``[lm-train]``'s 1024: four ranks share the card
  beside the phase's process) in 2 microbatches with remat and f32
  moments, the weights from seed 0 distributed from rank 0: each step's
  loss finite and within 1e-3 of the world-1 step, which the phase's
  process computes first and frees; every parameter's placements those of
  its ``logical_spec``.  At 2 layers in float64, 2 steps: the loss within
  1e-9 of world 1's, the grad norm and every leaf within 1e-6 (AdamW takes
  them in float32 in both packages); the ranks' checkpoint restores on
  world 1 bit for bit their shards; granite's top-k routes of the first
  step, every layer and microbatch, forward and rematerialised, equal
  world 1's rows (the count that differ printed, gate 0).  Prints ms per
  step per rank (host clock around a synchronised step), each rank's
  ``max_memory_allocated()`` over the steps beside ``dryrun_cell``'s
  predicted peak for one device of ``AbstractMesh((2, 2))`` (no gate), the
  collective route (``params.collective_route``) and the collectives of a
  float64 step.  Each rank must exit 0.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""
import os

# cuBLAS gives the same bits run to run only with a fixed workspace, which
# must be set before the first product ([lm-train]'s restart check)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import importlib
import json
import subprocess
import sys
import tempfile
import time
import warnings
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
# AdamW of the training phase: the trainer's schedule at a peak of 5e-3
# (at its default 2e-2 the unnormalized SAGE-max logits overshoot by the
# third step)
TRAIN_ADAMW = dict(lr_peak=5e-3, warmup_steps=5, decay_steps=500, weight_decay=0.0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*args) -> None:
    print(*args, flush=True)


def kernel_bytes(name: str, d, k: int) -> int:
    """Bytes kernel ``name`` must move on staged tiles ``d`` at width ``k``:
    each input read once, each output written once, as the TPU function
    does.  The partials kernels read the tiles and x and write one
    ``[T, group, k]`` block; the fused kernels read the tiles, the run
    index and x and write y.  The fused kernels' own intermediates (the
    chunk index and the split runs' chunk buffer) are not the function's
    work and stay out of the bound.  The argmax writes three outputs (y,
    idx, coeff)."""
    T, group, _ = d.data.shape
    moved = d.data.nbytes + d.cols.nbytes + d.colblock.nbytes + d.shape[1] * k * 4
    if "partials" in name:
        return moved + T * group * k * 4
    outputs = 3 if name.endswith("_argmax") else 1
    return (moved + d.run_start.nbytes + d.run_rowgroup.nbytes
            + outputs * d.n_rowgroups * group * k * 4)


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


def argmax_times_row(K, d, X, peak_bw: float) -> dict:
    """A ``[times]`` row of the argmax kernel on staged tiles ``d`` at
    ``X``'s width: beside it kernel 3 on the same tiles and x (the
    payload's cost over the plain max) and the torch lane chain it
    replaced on the card (its plain version)."""
    k = X.shape[1]
    iters = 20 if k < 128 else 10
    got, want = K.hbp_spmm_fused_argmax(d, X), K.hbp_spmm_fused_argmax_plain(d, X)
    exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
    del got, want
    return {
        "name": "hbp_spmm_fused_argmax", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hbp_argmax.cu", "replaces": None, "k": k,
        "exact": exact, "ms": timed_ms(lambda: K.hbp_spmm_fused_argmax(d, X), iters),
        "fused_max_ms": timed_ms(lambda: K.hbp_spmm_fused_max(d, X), iters),
        "plain_ms": timed_ms(lambda: K.hbp_spmm_fused_argmax_plain(d, X), 3, warmup=1),
        "bound_ms": kernel_bytes("hbp_spmm_fused_argmax", d, k) / peak_bw * 1e3,
    }


# GAT at the ogbn-arxiv widths (h100bench/configs/gat.json): heads, and a
# head's width in the hidden layers and in the output layer
GAT_HEADS, GAT_WIDTHS = 3, (250, 40)


def sddmm_library(indptr, cols, n: int, heads: int):
    """GAT's SDDMM by one ``torch.sparse.sampled_addmm`` (cuSPARSE's SDDMM)
    on a batched CSR of ``heads`` copies of the structure, the heads as the
    batch: ``(call, layout)``, where ``layout(dy, z)`` lays ``[n, H C]``
    operands out as the call takes them (``[H, n, C]``, ``[H, C, n]``) and
    ``call`` gives ``[H, nnz]``."""
    nnz = cols.numel()
    structure = torch.sparse_csr_tensor(
        indptr.expand(heads, -1).contiguous(), cols.long().expand(heads, -1).contiguous(),
        torch.zeros((heads, nnz), dtype=torch.float32, device=cols.device),
        size=(heads, n, n), check_invariants=False)

    def layout(dy, z):
        width = dy.shape[1] // heads
        return (dy.view(n, heads, width).transpose(0, 1).contiguous(),
                z.view(n, heads, width).permute(1, 2, 0).contiguous())

    def call(a, b):
        return torch.sparse.sampled_addmm(structure, a, b, beta=0.0).values().view(heads, nnz)

    return call, layout


def sddmm_times_rows(adj, dev, g, smi_line: str) -> list:
    """``[times]`` rows of GAT's SDDMM kernel on the CSR ``adj`` (``A +
    I``), ``GAT_HEADS`` heads at each of ``GAT_WIDTHS``: held to a float64
    ``ref.sddmm`` at the tolerance of ``tests/test_torch_gpu.py``'s SDDMM
    test and to itself on a second launch, its launches counted from a
    reset, beside its plain version, ``sddmm_library``'s call on the same
    operands (its layout not timed) and the work model's bound
    (``h100bench/work/gat.py``: what ``sddmm_roofline.train`` reads)."""
    from h100bench.peaks import peaks_for
    from h100bench.work import gat as gat_work
    from repro_torch.kernels import ref

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    peaks = peaks_for(torch.cuda.get_device_name(dev))
    n, nnz, heads = adj.shape[0], adj.nnz, GAT_HEADS
    indptr = torch.as_tensor(adj.indptr, dtype=torch.int64, device=dev)
    cols = torch.as_tensor(adj.indices, dtype=torch.int32, device=dev)
    library, layout = sddmm_library(indptr, cols, n, heads)
    rows = []
    for width in GAT_WIDTHS:
        dy = torch.randn((n, heads * width), device=dev, generator=g)
        z = torch.randn((n, heads * width), device=dev, generator=g)

        def kernel():
            return K.hbp_sddmm(indptr, cols, dy, z, heads)

        K.hbp_sddmm.launches = 0
        got = kernel()
        want = ref.sddmm(indptr, cols, dy.double(), z.double(), heads)
        err = (got.double() - want).abs()
        check(bool(torch.all(err <= 1e-5 * want.abs() + 1e-5 * width ** 0.5)),
              f"SDDMM kernel at C={width}: disagrees with the float64 plain version "
              f"(max abs err {err.max().item():.3e})")
        check(torch.equal(got, kernel()), f"SDDMM kernel at C={width}: two launches differ")
        operands = layout(dy, z)
        library_err = (library(*operands).t().double() - want).abs().max().item()
        max_err = err.max().item()
        del got, want, err
        iters = 20
        ms = timed_ms(kernel, iters)
        calls = 2 + 2 + iters  # the checks, timed_ms's warm-up, the timed calls
        check(K.hbp_sddmm.launches == calls,
              f"SDDMM kernel at C={width}: {K.hbp_sddmm.launches} launches for {calls} calls")
        rows.append({
            "name": "hbp_sddmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hbp_sddmm.cu", "replaces": None,
            "matrix": "A + I", "n": n, "nnz": nnz, "heads": heads, "C": width,
            "launches": K.hbp_sddmm.launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": timed_ms(lambda: ref.sddmm(indptr, cols, dy, z, heads), 3, warmup=1),
            "library_ms": timed_ms(lambda: library(*operands), iters),
            "library_max_abs_err": library_err,
            "bound_ms": gat_work.sddmm(n, nnz, heads, width).bound_s(peaks) * 1e3,
            "card": smi_line,
        })
        del operands, dy, z
    return rows


def softmax_times_rows(adj, dev, g, smi_line: str) -> list:
    """``[times]`` rows of GAT's edge softmax kernels (``csrc/hbp_softmax.cu``)
    on the CSR ``adj`` (``A + I``, symmetric: one tile set serves A and
    Aᵀ, as the registry's self-linked pair does), ``GAT_HEADS`` heads: the
    forward (``hbp_edge_softmax`` and ``hbp_rewrite`` into A's copies) and
    the backward (``hbp_edge_softmax_backward``, ``hbp_edge_softmax_columns``
    and ``hbp_rewrite`` into Aᵀ's copies), each held to its float64 plain
    version (``ref.edge_softmax*``, ``ref.rewritten_values``) within ``1e-5 *
    |want| + 1e-5 * max(1, |want|_inf)`` and to itself on a second launch,
    its launches counted from a reset, beside its plain version on the card
    (the torch segment passes it replaced) and the work model's bound
    (``h100bench/work/gat.py``'s ``softmax()``: what ``attn_ms.train``
    covers)."""
    from h100bench.peaks import peaks_for
    from h100bench.work import gat as gat_work
    from repro_torch.core import build_tiles, tuned_partition_config
    from repro_torch.kernels import autodiff, ref

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    peaks = peaks_for(torch.cuda.get_device_name(dev))
    n, nnz, heads = adj.shape[0], adj.nnz, GAT_HEADS
    tiles = build_tiles(adj, tuned_partition_config(adj))
    m = autodiff.attention_maps(adj, tiles, tiles, dev)
    s_src, s_dst = torch.randn((2, n, heads), device=dev, generator=g).unbind(0)
    d_alpha = torch.randn((nnz, heads), device=dev, generator=g)
    wrappers = (K.hbp_edge_softmax, K.hbp_edge_softmax_backward, K.hbp_edge_softmax_columns,
                K.hbp_rewrite)

    def forward():
        alpha = K.hbp_edge_softmax(m.indptr, m.cols, m.walk, s_src, s_dst)
        return alpha, K.hbp_rewrite(m.entry, alpha)

    alpha = forward()[0]

    def backward():
        de, d_dst = K.hbp_edge_softmax_backward(m.indptr, m.cols, m.walk, s_src, s_dst, alpha,
                                                d_alpha)
        return (de, d_dst, K.hbp_edge_softmax_columns(m.indptr_T, m.perm_T, m.walk_T, de),
                K.hbp_rewrite(m.entry_T, alpha))

    def plain_forward(src, dst):
        a = ref.edge_softmax(m.indptr, m.cols, src, dst)
        return a, ref.rewritten_values(m.entry, a)

    def plain_backward(src, dst, a, da):
        de, d_dst = ref.edge_softmax_backward(m.indptr, m.cols, src, dst, a, da)
        return (de, d_dst, ref.edge_softmax_columns(m.indptr_T, m.perm_T, de),
                ref.rewritten_values(m.entry_T, a))

    f64 = [t.double() for t in (s_src, s_dst, alpha, d_alpha)]
    rows = []
    for name, kernel, plain, plain_args, backward_work in (
            ("hbp_edge_softmax", forward, plain_forward, (s_src, s_dst), False),
            ("hbp_edge_softmax_backward", backward, plain_backward,
             (s_src, s_dst, alpha, d_alpha), True)):
        for w in wrappers:
            w.launches = 0
        got = kernel()
        want = plain(*f64[:len(plain_args)])
        max_err = 0.0
        for a, b in zip(got, want):
            err = (a.double() - b).abs()
            check(bool(torch.all(err <= 1e-5 * b.abs() + 1e-5 * max(1.0, b.abs().max().item()))),
                  f"{name}: disagrees with the float64 plain version "
                  f"(max abs err {err.max().item():.3e})")
            max_err = max(max_err, err.max().item())
        check(all(torch.equal(a, b) for a, b in zip(got, kernel())),
              f"{name}: two launches differ")
        del got, want
        iters = 20
        ms = timed_ms(kernel, iters)
        calls = 2 + 2 + iters  # the checks, timed_ms's warm-up, the timed calls
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        check(launches and all(v == calls for v in launches.values()),
              f"{name}: {launches} launches for {calls} calls")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hbp_softmax.cu", "replaces": None,
            "matrix": "A + I", "n": n, "nnz": nnz, "heads": heads, "slots": tiles.data.size,
            "long_rows": m.walk.n_long, "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": timed_ms(lambda: plain(*plain_args), 3, warmup=1),
            "bound_ms": gat_work.softmax(n, nnz, heads, backward=backward_work).bound_s(peaks)
            * 1e3,
            "card": smi_line,
        })
    return rows


def gat_kernels_phase() -> None:
    """The SDDMM and edge softmax rows of ``[times]`` alone, on ``A + I`` of
    the graph phase's ``rmat_graph(1 << 16, 79.345703125, seed=4)``:
    ``python -c "import chip_smoke; chip_smoke.gat_kernels_phase()"``."""
    from repro_torch.graph import add_self_loops, rmat_graph

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    adj = add_self_loops(rmat_graph(1 << 16, 79.345703125, seed=4))
    g = torch.Generator(device=dev).manual_seed(0)
    for row in sddmm_times_rows(adj, dev, g, smi_line) + softmax_times_rows(adj, dev, g,
                                                                              smi_line):
        log("[times] " + json.dumps(row))


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


class Float64Transpose:
    """``Aᵀ`` and ``|Aᵀ|`` in float64 on the card: the reference the sum
    and mean backward (``x̄ = Aᵀ (ȳ / d)``) is held against."""

    def __init__(self, csr, dev):
        self.T = Float64Csr(csr.transpose(), dev)
        self.div = torch.as_tensor(np.maximum(np.diff(csr.indptr), 1), dtype=torch.float64,
                                   device=dev)[:, None]

    def check(self, xbar, ybar, what: str, mean: bool = False) -> None:
        g = ybar.double() / self.div if mean else ybar.double()
        self.T.check(xbar, g, what)


def scatter_reference(y_bar, idx, coeff, n_cols: int):
    """The max backward in float64 (each ``coeff * ȳ`` exact there), with
    the bound of an f32 scatter in any order: an element receiving ``m``
    terms is within ``(m + 1) * 2**-24 * sum|terms|`` of the exact sum."""
    k = y_bar.shape[1]
    live = idx >= 0
    flat = (idx.clamp(min=0).long() * k + torch.arange(k, device=idx.device)).reshape(-1)
    terms = torch.where(live, coeff.double() * y_bar.double(), 0.0).reshape(-1)
    zeros = torch.zeros(n_cols * k, dtype=torch.float64, device=idx.device)
    exact = zeros.index_add(0, flat, terms).reshape(n_cols, k)
    mag = zeros.index_add(0, flat, terms.abs()).reshape(n_cols, k)
    m = zeros.index_add(0, flat, live.reshape(-1).double()).reshape(n_cols, k)
    return exact, (m + 1) * 2.0 ** -24 * mag


def train_phase(graph_regs, A_sym, dev, g, wrappers, reset_counts, read_counts) -> None:
    """GCN, SAGE-mean and SAGE-max training on the card at the ogbn-arxiv
    GraphSAGE widths (see the module docstring, phase ``train``)."""
    from repro_torch.analysis.roofline import spec_for
    from repro_torch.graph import add_self_loops, normalize_adjacency, rmat_graph
    from repro_torch.graph import plan_diff_aggregator
    from repro_torch.graph.train import NodeClassifierTrainer
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig

    adamw = AdamWConfig(**TRAIN_ADAMW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A_ns = rmat_graph(1 << 16, 79.345703125, seed=4, symmetric=False)
    n = A_ns.shape[0]
    regs = graph_regs  # A_hat is resident there from the graph phase
    plans = {s: reg.admit_pair(A_ns, "A_ns") for s, reg in regs.items()}
    for s, reg in regs.items():
        check(reg.transpose_of(plans[s]) is not plans[s], "A_ns self-linked")
    log(f"[train] A_ns {A_ns.shape} nnz={A_ns.nnz} (symmetric=False), admitted with its "
        f"transpose under fused and partials in {time.perf_counter() - t0:.1f} s; tiles "
        f"A {plans['fused'].tiles.n_tiles}, A^T {regs['fused'].transpose_of(plans['fused']).tiles.n_tiles}")
    A_hat = normalize_adjacency(add_self_loops(A_sym), "sym")
    for s, reg in regs.items():
        p_hat = reg.admit_pair(A_hat)
        check(reg.transpose_of(p_hat) is p_hat, f"{s}: the symmetric A_hat is not self-linked")

    # gradient checks on the served pair, one backward alone per op
    ref_T = Float64Transpose(A_ns, dev)
    x = torch.randn(n, GNN_DIMS[1], device=dev, generator=g)
    y_bar = torch.randn(n, GNN_DIMS[1], device=dev, generator=g)
    backward_kernel = {"fused": "hbp_spmm_fused", "partials": "hbp_spmm_partials"}
    for s, plan in plans.items():
        for op in ("sum", "mean"):
            xr = x.clone().requires_grad_(True)
            y = plan_diff_aggregator(plan, op=op)(xr)
            reset_counts()
            (x_bar,) = torch.autograd.grad(y, xr, y_bar)
            torch.cuda.synchronize()
            counts = read_counts((backward_kernel[s],))
            check(counts[backward_kernel[s]] > 0,
                  f"{s} {op}: the backward launched no {backward_kernel[s]}: {counts}")
            ref_T.check(x_bar, y_bar, f"{s} {op} backward", mean=op == "mean")
        log(f"[train] {s}: sum and mean backward (x_bar = A^T (y_bar / d)) within "
            f"1e-5 * (|A^T| |y_bar|) of float64; {backward_kernel[s]} launched in the backward "
            f"alone ({counts[backward_kernel[s]]} for mean)")
    # max: the argmax triple on the card is the CPU's, bit for bit, on
    # sampled columns; the scatter within the bound of its atomic order
    plan = plans["fused"]
    xr = x.clone().requires_grad_(True)
    f_max = plan_diff_aggregator(plan, op="max")
    y = f_max(xr)
    check(torch.equal(y.detach().view(torch.int32), ops.hbp_spmm(
        plan.device, x, strategy="stable", combine="max").view(torch.int32)),
          "max aggregation != the stable max SpMM")
    y_c, idx_c, coeff_c = ops.hbp_spmm_argmax(plan.device, x)
    cols = [0, GNN_DIMS[1] // 2, GNN_DIMS[1] - 1]
    dt_cpu = ops.device_tiles(plan.tiles, "cpu")
    cpu = ops.hbp_spmm_argmax(dt_cpu, x[:, cols].cpu())
    for name, a, b in zip(("y", "idx", "coeff"), (y_c, idx_c, coeff_c), cpu):
        check(torch.equal(a[:, cols].cpu().view(torch.int32), b.view(torch.int32)),
              f"argmax {name}: the card differs from the CPU on sampled columns")
    (x_bar,) = torch.autograd.grad(y, xr, y_bar)
    exact, bound = scatter_reference(y_bar, idx_c, coeff_c, n)
    err = (x_bar.double() - exact).abs()
    check(bool(torch.all(err <= bound)), f"max backward: err {err.max().item():.3e} over its bound")
    log(f"[train] max: y, idx, coeff bitwise the CPU argmax on columns {cols}; y bitwise the "
        f"stable max SpMM; x_bar within (m + 1) * 2^-24 * sum|coeff * y_bar| of a float64 "
        f"scatter (max err {err.max().item():.3e}, {int((idx_c >= 0).sum())} live of "
        f"{idx_c.numel()})")
    del ref_T, x, y_bar, xr, y, y_c, idx_c, coeff_c, dt_cpu, cpu, exact, bound, err, x_bar

    # training runs: the same carried weights under both strategies
    gx = torch.Generator(device=dev).manual_seed(8)
    feats = torch.randn(n, GNN_DIMS[0], device=dev, generator=gx)
    proj = torch.randn(GNN_DIMS[0], GNN_DIMS[-1], device=dev, generator=gx)
    labels = torch.argmax(feats @ proj, dim=1)  # a learnable signal
    runs = {"gcn": ("gcn", "sum", A_sym), "sage-mean": ("sage", "mean", A_ns),
            "sage-max": ("sage", "max", A_ns)}
    step_ms, histories = {}, {}

    def timed_steps(trainer, state, agg, n_steps=2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n_steps):
            state, _ = trainer.step(state, agg, feats, labels)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_steps

    reset_counts()
    for rname, (model, op, adj) in runs.items():
        for s, reg in regs.items():
            trainer = NodeClassifierTrainer(GNN_DIMS, model=model, op=op, registry=reg,
                                            adamw=adamw)
            check(trainer.device == reg.device, "the trainer left its registry's device")
            state, hist = trainer.fit(adj, feats, labels, steps=3, key=9)
            losses = [h["loss"] for h in hist]
            check(all(np.isfinite(losses)), f"{rname} {s}: losses {losses}")
            check(losses[-1] < losses[0], f"{rname} {s}: loss did not fall: {losses}")
            histories[rname, s] = losses
            agg = trainer.aggregator(trainer.prepare_adjacency(adj))
            step_ms[rname, s] = timed_steps(trainer, state, agg)
        a, b = np.array(histories[rname, "fused"]), np.array(histories[rname, "partials"])
        check(np.allclose(a, b, rtol=1e-3, atol=0.0),
              f"{rname}: fused and partials histories disagree: {a} vs {b}")
        log(f"[train] {rname}: fit 3 steps, losses fused {a.tolist()} partials {b.tolist()}; "
            f"ms per train step (CUDA events, 2 steps after fit): fused "
            f"{step_ms[rname, 'fused']:.3f}, partials {step_ms[rname, 'partials']:.3f}")

    log(f"[train] kernel launches over the six fit runs and their timed steps: "
        f"{read_counts(tuple(wrappers))}")

    # the argmax at the SAGE-max widths, and its share of a SAGE-max step
    dt_a = plans["fused"].device
    argmax_ms = {}
    for k in (GNN_DIMS[0], GNN_DIMS[1]):
        xk = torch.randn(n, k, device=dev, generator=g)
        argmax_ms[k] = timed_ms(lambda: ops.hbp_spmm_argmax(dt_a, xk), 3, warmup=1)
    T, group, _ = dt_a.data.shape
    # bytes the argmax must move at k = 256: the tiles, x, and y, idx, coeff
    bound = (dt_a.data.nbytes + dt_a.cols.nbytes + dt_a.colblock.nbytes
             + n * GNN_DIMS[1] * 4 * 4) / spec_for(torch.cuda.get_device_name(0)).hbm_bw * 1e3
    per_step = argmax_ms[GNN_DIMS[0]] + 2 * argmax_ms[GNN_DIMS[1]]  # three layers
    log(f"[train] argmax SpMM on A_ns: {argmax_ms[GNN_DIMS[0]]:.3f} ms at k={GNN_DIMS[0]}, "
        f"{argmax_ms[GNN_DIMS[1]]:.3f} ms at k={GNN_DIMS[1]} (bound {bound:.4f} ms); "
        f"T={T} tiles of [{group}, {dt_a.data.shape[2]}]; the three forward argmaxes take "
        f"{per_step:.3f} ms = {100 * per_step / step_ms['sage-max', 'fused']:.1f} % of a fused "
        f"SAGE-max step ({step_ms['sage-max', 'fused']:.3f} ms)")

    # neighbor-sampled mini-batches: two epochs of the same four batches
    reg = regs["fused"]
    trainer = NodeClassifierTrainer(GNN_DIMS, model="sage", op="mean", registry=reg,
                                    adamw=adamw)
    train_nodes = np.random.default_rng(10).choice(n, 4 * 1024, replace=False)
    t0 = time.perf_counter()
    state, h1 = trainer.fit_sampled(A_ns, feats, labels, steps=4, batch_size=1024,
                                    fanouts=(10, 5), train_nodes=train_nodes, seed=11, key=9)
    t1 = time.perf_counter()
    misses = reg.metrics.value("registry.misses", 0)
    resident = len(reg)
    state, h2 = trainer.fit_sampled(A_ns, feats, labels, steps=4, batch_size=1024,
                                    fanouts=(10, 5), train_nodes=train_nodes, seed=11,
                                    state=state)
    t2 = time.perf_counter()
    check(reg.metrics.value("registry.misses", 0) == misses and len(reg) == resident,
          "the second epoch admitted new plans")
    check([h["batch_nodes"] for h in h1] == [h["batch_nodes"] for h in h2],
          "the second epoch sampled other batches")
    losses = [h["loss"] for h in h1 + h2]
    check(all(np.isfinite(losses)), f"fit_sampled losses {losses}")
    log(f"[train] fit_sampled SAGE-mean fanouts (10, 5), batch 1024: epoch 1 {t1 - t0:.1f} s "
        f"(batch nodes {[h['batch_nodes'] for h in h1]}), epoch 2 {t2 - t1:.1f} s with no new "
        f"admission ({resident} plans resident); losses {[round(v, 4) for v in losses]}")
    log(f"[train] torch.cuda.max_memory_allocated over the phase: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# --- the solvers phase ------------------------------------------------------

# Poisson grids of the phase: CG and Chebyshev on SOLVER_GRID^2 rows,
# preconditioned CG and the registry's measured search on PCG_GRID^2.
# CG and Chebyshev were to run on 1024^2 (1,048,576 rows); the phase is
# cut to 512^2 because the host-side tile build of the 1024^2 Laplacian
# alone took 337 s on the card's host (build_tiles' per-block numpy work
# grows with row blocks times column blocks), over the phase's minute.
SOLVER_GRID = 512
CUT_FROM_GRID = 1024
PCG_GRID = 512
# CHECK_EVERY values whose CG cost the phase prints beside the default
CHECK_EVERY_SWEEP = (1, 2, 4, 8, 16, 32)
# The float64 true residual of an f32 solve may exceed its recurrence
# residual by the rounding gap: x is stored in f32, so even the exact
# solution rounded to f32 leaves up to u * || |A| |x| || / ||b|| (u =
# 2**-24), and the recurrence's updates add their own rounding.  That gap
# measured 3-6x the floor for CG on Poisson 64^2-256^2, PCG on its scaled
# form and BiCGSTAB on m11_rajat21 (the plain versions on the CPU); 16x
# leaves room, and still fails a solve that is wrong by orders of magnitude.
GAP_FLOOR_FACTOR = 16
# The kernel each strategy launches at k = 1 and at k > 1.
SOLVER_KERNELS = {("fused", False): "hbp_spmv_fused", ("fused", True): "hbp_spmm_fused",
                  ("partials", False): "hbp_spmv_partials",
                  ("partials", True): "hbp_spmm_partials"}


def poisson2d(g: int):
    """5-point Laplacian on a g x g grid, the canonical SPD CG system (a
    copy of ``benchmarks/bench_solvers.py``'s ``poisson2d``)."""
    from repro_torch.core import COOMatrix, csr_from_coo

    n = g * g
    i = np.arange(n)
    ix, iy = i // g, i % g
    rows, cols, vals = [i], [i], [np.full(n, 4.0)]
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (0 <= ix + dx) & (ix + dx < g) & (0 <= iy + dy) & (iy + dy < g)
        rows.append(i[ok])
        cols.append((ix[ok] + dx) * g + iy[ok] + dy)
        vals.append(np.full(ok.sum(), -1.0))
    return csr_from_coo(
        COOMatrix(np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)))


def shifted(csr, sigma: float):
    """A + sigma I (a copy of ``benchmarks/bench_solvers.py``'s ``shifted``)."""
    from repro_torch.core import COOMatrix, csr_from_coo

    coo = csr.to_coo()
    n = csr.n_rows
    return csr_from_coo(COOMatrix(
        np.concatenate([coo.row, np.arange(n)]), np.concatenate([coo.col, np.arange(n)]),
        np.concatenate([coo.data, np.full(n, sigma)]), csr.shape))


def scaled(csr, d: np.ndarray):
    """D A D for the diagonal ``d``."""
    from repro_torch.core import CSRMatrix

    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    return CSRMatrix(csr.indptr, csr.indices, csr.data * d[rows] * d[csr.indices], csr.shape)


def plain_operator(tiles, strategy: str, dev):
    """The solvers' operator on the card with each kernel replaced by its
    plain version: what ``ops`` runs under ``strategy``, bit for bit but
    for the kernel call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.solvers import LinearOperator

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    dt = ops.device_tiles(tiles, dev)
    n = dt.shape[0]

    def hashed(x):
        if strategy == "fused":
            return K.hbp_spmm_fused_plain(dt, x)
        return ref.segment_sum_sorted(K.hbp_spmm_partials_plain(dt, x), dt.rowgroup,
                                      dt.n_rowgroups, dt.rg_lengths)

    return LinearOperator(
        dt.shape, matvec=lambda x: ref.unpermute(hashed(x[:, None])[..., 0], dt.perm, n),
        matmat=lambda x: ref.unpermute(hashed(x), dt.perm, n), device=dev)


def device_kernel_ms(fn) -> dict:
    """{kernel name: ms of device time} on the card during one call of
    ``fn`` (``torch.profiler``); empty when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def kernel_device_ms(fn):
    """(ms of the HBP kernels, ms of every kernel) on the card during one
    call of ``fn``, or ``(None, None)`` when the profiler records no device
    time."""
    ms = device_kernel_ms(fn)
    if not ms:
        return None, None
    return sum(v for k, v in ms.items() if "hbp_" in k), sum(ms.values())


def solvers_phase(kron, A_sym, dev, g, reset_counts, read_counts, cache: str) -> dict:
    """The iterative solvers on the card through the HBP kernels (see the
    module docstring, phase ``solvers``).  Returns each kernel's launches
    over the phase."""
    import scipy.sparse
    import scipy.sparse.linalg

    from repro_torch.core import build_tiles, enumerate_configs, tuned_partition_config
    from repro_torch.serving import MatrixRegistry, cg_probe
    from repro_torch.solvers import (aslinearoperator, bicgstab, block_jacobi, cg, chebyshev,
                                     hash_group_blocks, jacobi, pagerank, power_iteration,
                                     transition_matrix)
    from repro_torch.solvers import base

    t_phase = time.perf_counter()
    totals = {name: 0 for name in SOLVER_KERNELS.values()}
    u = 2.0 ** -24

    def colnorm(v):
        return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=0)

    def counted(run, kernels):
        """One solve with the launch counters from 0 and every host sync
        counted (set_sync_debug_mode("warn"))."""
        reset_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        counts = read_counts(kernels)
        for name, n in counts.items():
            totals[name] += n
        return res, syncs, counts

    def solve(label, run, *, kernels, setup, per_step, A64=None, b=None, converge=True,
              profile=True):
        """Run, check and time one solve; returns its result and a record."""
        res, syncs, counts = counted(run, kernels)
        it = int(res.iterations)
        launched = sum(counts.values())
        wasted = launched - setup - per_step * it
        check(launched > 0, f"[solvers] {label}: no kernel launched: {counts}")
        check(syncs >= 1 and wasted >= 0, f"[solvers] {label}: {syncs} syncs, {wasted} wasted")
        if converge:
            check(bool(res.converged), f"[solvers] {label}: did not converge in {it} steps")
        rec = {"solve": label, "iterations": it, "converged": bool(res.converged),
               "host_syncs": syncs, "launches": counts, "wasted_launches": wasted}
        if A64 is not None:
            xd, bd = res.x.double().reshape(b.shape[0], -1), b.double().reshape(b.shape[0], -1)
            bn = colnorm(bd)
            true_rel = colnorm(bd - A64.A @ xd) / bn
            bound = res.residual.double().reshape(-1) / bn + GAP_FLOOR_FACTOR * u * colnorm(
                A64.absA @ xd.abs()) / bn
            check(bool(torch.all(true_rel <= bound)),
                  f"[solvers] {label}: true residual {true_rel.max().item():.3e} over its "
                  f"bound {bound.max().item():.3e}")
            rec["true_residual"] = true_rel.max().item()
            rec["residual_bound"] = bound.max().item()
        rec["ms"] = timed_ms(run, 1, warmup=0)
        rec["ms_per_iter"] = rec["ms"] / max(it, 1)
        if profile:
            hbp_ms, busy_ms = kernel_device_ms(run)
            rec["kernel_share"] = None if hbp_ms is None else hbp_ms / rec["ms"]
            rec["device_busy"] = None if busy_ms is None else busy_ms / rec["ms"]
        share = rec.get("kernel_share")
        log(f"[solvers] {label}: {it} iterations, converged={rec['converged']}, "
            + (f"true residual {rec['true_residual']:.3e} (bound {rec['residual_bound']:.3e}), "
               if A64 is not None else "")
            + f"{rec['ms']:.3f} ms per solve, {rec['ms_per_iter']:.4f} ms per iteration (CUDA "
            f"events), {syncs} host syncs, launches {counts} ({wasted} masked), HBP kernels "
            + ("not measured" if share is None else
               f"{100 * share:.1f} % of the solve, device busy {100 * rec['device_busy']:.1f} %"))
        return res, rec

    records = []
    # --- CG, block CG and Chebyshev on 2D Poisson ------------------------
    t0 = time.perf_counter()
    P = poisson2d(SOLVER_GRID)
    P_tiles = build_tiles(P, tuned_partition_config(P))
    P64 = Float64Csr(P, dev)
    n = P.shape[0]
    log(f"[solvers] depth cut: CG and Chebyshev on Poisson {SOLVER_GRID}^2, not "
        f"{CUT_FROM_GRID}^2 (its host-side tile build alone outlasts the phase's minute)")
    log(f"[solvers] Poisson {SOLVER_GRID}^2: {n} rows, {P.nnz} stored entries, cfg "
        f"{P_tiles.cfg}, {P_tiles.n_tiles} tiles, built in {time.perf_counter() - t0:.1f} s")
    b1 = torch.randn(n, device=dev, generator=g)
    b8 = torch.randn(n, 8, device=dev, generator=g)
    for strategy in ("fused", "partials"):
        op = aslinearoperator(P_tiles, strategy=strategy, device=dev)
        for b in (b1, b8):
            k = 1 if b.dim() == 1 else b.shape[1]
            res, rec = solve(f"CG poisson{SOLVER_GRID} k={k} {strategy}",
                             lambda: cg(op, b, tol=1e-5, maxiter=8000),
                             kernels=(SOLVER_KERNELS[strategy, k > 1],), setup=1, per_step=1,
                             A64=P64, b=b)
            records.append(rec)
            if strategy == "fused" and k == 1:
                cg_default = res
        # Chebyshev: lam_max = 8 (Gershgorin), lam_min = 8 / 30, 40 steps
        cheb = dict(lam_min=8.0 / 30, lam_max=8.0, tol=0.0, maxiter=40)
        res, rec = solve(f"Chebyshev40 poisson{SOLVER_GRID} {strategy}",
                         lambda: chebyshev(op, b1, **cheb),
                         kernels=(SOLVER_KERNELS[strategy, False],), setup=1, per_step=1,
                         A64=P64, b=b1, converge=False)
        check(int(res.iterations) == 40, f"Chebyshev ran {int(res.iterations)} steps, not 40")
        plain = chebyshev(plain_operator(P_tiles, strategy, dev), b1, **cheb)
        err = (res.x - plain.x).abs()
        check(bool(torch.all(err <= 1e-4 * (plain.x.abs() + plain.x.abs().max()))),
              f"Chebyshev {strategy}: {err.max().item():.3e} from the plain versions")
        log(f"[solvers] Chebyshev40 {strategy}: within rtol=1e-4 of the same run on the plain "
            f"versions on the card (max abs diff {err.max().item():.3e}); residual "
            f"{res.history[0].item():.4e} -> {res.history[40].item():.4e}")
        records.append(rec)
        del op

    # CHECK_EVERY: the same CG solve, bit for bit, at each value
    op = aslinearoperator(P_tiles, strategy="fused", device=dev)
    default_every = base.CHECK_EVERY
    sweep = {every: {"ms": []} for every in CHECK_EVERY_SWEEP}
    run = lambda: cg(op, b1, tol=1e-5, maxiter=8000)  # noqa: E731
    try:
        # host-bound solves drift within a process: time the values in
        # turn, up the sweep and back down
        for every in CHECK_EVERY_SWEEP + CHECK_EVERY_SWEEP[::-1]:
            base.CHECK_EVERY = every
            if "host_syncs" not in sweep[every]:
                res, syncs, counts = counted(run, ("hbp_spmv_fused",))
                check(torch.equal(res.x, cg_default.x)
                      and int(res.iterations) == int(cg_default.iterations),
                      f"CG at CHECK_EVERY={every} differs from the default's bits")
                sweep[every].update(host_syncs=syncs, wasted_launches=(
                    counts["hbp_spmv_fused"] - 1 - int(res.iterations)))
            sweep[every]["ms"].append(timed_ms(run, 1, warmup=0))
    finally:
        base.CHECK_EVERY = default_every
    log(f"[solvers] CHECK_EVERY sweep, CG poisson{SOLVER_GRID} k=1 fused "
        f"({int(cg_default.iterations)} iterations, x bitwise equal at every value; default "
        f"{default_every}; ms per solve up the sweep / down it): " + "; ".join(
            f"{e}: {v['ms'][0]:.3f} / {v['ms'][1]:.3f} ms, {v['host_syncs']} syncs, "
            f"{v['wasted_launches']} masked launches" for e, v in sweep.items()))
    log(f"[solvers] CG, Chebyshev and the sweep: {time.perf_counter() - t0:.1f} s")
    del op, P64, P_tiles, P, b1, b8

    # --- preconditioned CG on a badly scaled Poisson ---------------------
    t0 = time.perf_counter()
    P = poisson2d(PCG_GRID)
    d = 10.0 ** np.random.default_rng(17).uniform(-2, 2, P.shape[0])
    D = scaled(P, d)
    D_tiles = build_tiles(D, tuned_partition_config(D))
    D64 = Float64Csr(D, dev)
    blocks = hash_group_blocks(D_tiles)
    M_jac, M_bj = jacobi(D, device=dev), block_jacobi(D, blocks=blocks, device=dev)
    log(f"[solvers] D A D on Poisson {PCG_GRID}^2, d log-uniform over [1e-2, 1e2]: "
        f"{D.shape[0]} rows, {len(blocks)} hash-group blocks, built in "
        f"{time.perf_counter() - t0:.1f} s")
    b = torch.randn(D.shape[0], device=dev, generator=g)
    op = aslinearoperator(D_tiles, strategy="fused", device=dev)
    plain_cg, _ = solve(f"CG (no M) scaled poisson{PCG_GRID} fused",
                        lambda: cg(op, b, tol=1e-5, maxiter=4000),
                        kernels=("hbp_spmv_fused",), setup=1, per_step=1, converge=False,
                        profile=False)
    plain_op = plain_operator(D_tiles, "fused", dev)
    for name, M in (("jacobi", M_jac), ("block-jacobi", M_bj)):
        res, rec = solve(f"PCG {name} scaled poisson{PCG_GRID} fused",
                         lambda: cg(op, b, tol=1e-5, maxiter=4000, M=M),
                         kernels=("hbp_spmv_fused",), setup=1, per_step=1, A64=D64, b=b)
        records.append(rec)
        it = int(res.iterations)
        check(it < int(plain_cg.iterations),
              f"PCG {name}: {it} iterations, plain CG {int(plain_cg.iterations)}")
        ref_it = int(cg(plain_op, b, tol=1e-5, maxiter=4000, M=M).iterations)
        check(abs(it - ref_it) <= 0.02 * ref_it,
              f"PCG {name}: {it} iterations, {ref_it} on the plain versions")
        log(f"[solvers] PCG {name}: {it} iterations against {int(plain_cg.iterations)} for CG "
            f"without M (converged={bool(plain_cg.converged)}, capped at 4000) and {ref_it} on "
            "the plain versions on the card (within 2 %)")
    del op, plain_op, D64, D_tiles, M_jac, M_bj
    log(f"[solvers] PCG: {time.perf_counter() - t0:.1f} s")

    # --- BiCGSTAB on the shifted circuit matrix ---------------------------
    from repro_torch.core.matrices import SUITE_SPECS

    t0 = time.perf_counter()
    C = SUITE_SPECS["m11_rajat21"](0)
    N = shifted(C, 1.5 * float(np.abs(C.data).max()))
    N_tiles = build_tiles(N, tuned_partition_config(N))
    N64 = Float64Csr(N, dev)
    B = torch.randn(N.shape[0], 8, device=dev, generator=g)
    M = jacobi(N, device=dev)
    log(f"[solvers] m11_rajat21 + 1.5 max|a| I: {N.shape[0]} rows, {N.nnz} entries, "
        f"{N_tiles.n_tiles} tiles")
    for strategy in ("fused", "partials"):
        op = aslinearoperator(N_tiles, strategy=strategy, device=dev)
        for bb in (B[:, 0].contiguous(), B):
            wide = bb.dim() == 2
            for mname, MM in (("", None), (" jacobi", M)):
                _, rec = solve(f"BiCGSTAB{mname} rajat21 k={8 if wide else 1} {strategy}",
                               lambda: bicgstab(op, bb, tol=1e-6, maxiter=500, M=MM),
                               kernels=(SOLVER_KERNELS[strategy, wide],), setup=1, per_step=2,
                               A64=N64, b=bb)
                records.append(rec)
    del op, N64, N_tiles
    log(f"[solvers] BiCGSTAB: {time.perf_counter() - t0:.1f} s")

    # --- PageRank on m4_kron16's transition matrix ------------------------
    t0 = time.perf_counter()
    Mt, dang = transition_matrix(kron)
    M_tiles = build_tiles(Mt, tuned_partition_config(Mt))
    S64 = scipy.sparse.csr_matrix((Mt.data, Mt.indices, Mt.indptr), shape=Mt.shape)
    nk = Mt.shape[0]
    pers = torch.rand(nk, 8, device=dev, generator=g) + 0.01
    log(f"[solvers] transition matrix of m4_kron16: {nk} nodes, {Mt.nnz} edges, "
        f"{int(dang.sum())} dangling, {M_tiles.n_tiles} tiles")
    for strategy in ("fused", "partials"):
        op = aslinearoperator(M_tiles, strategy=strategy, device=dev)
        for P8 in (None, pers):
            wide = P8 is not None
            res, rec = solve(f"PageRank kron16 k={8 if wide else 1} {strategy}",
                             lambda: pagerank(op, damping=0.85, personalization=P8,
                                              dangling=dang, tol=1e-8),
                             kernels=(SOLVER_KERNELS[strategy, wide],), setup=0, per_step=1)
            # the same recurrence in float64 for the same number of steps
            v = (np.full((nk, 1), 1.0 / nk) if P8 is None
                 else P8.double().cpu().numpy() / P8.double().sum(0).cpu().numpy())
            p = v.copy()
            for _ in range(int(res.iterations)):
                p = 0.85 * (S64 @ p + (dang.astype(np.float64) @ p) * v) + 0.15 * v
            l1 = np.abs(res.x.double().cpu().numpy().reshape(nk, -1) - p).sum(0)
            check(bool(np.all(l1 <= 1e-5)), f"PageRank {strategy}: L1 {l1.max():.3e} from f64")
            rec["l1_vs_float64"] = float(l1.max())
            log(f"[solvers] PageRank k={8 if wide else 1} {strategy}: L1 per column "
                f"{l1.max():.3e} from the float64 recurrence (scipy.sparse) at "
                f"{int(res.iterations)} steps")
            records.append(rec)
    del op, M_tiles
    log(f"[solvers] PageRank: {time.perf_counter() - t0:.1f} s")

    # --- power iteration on the symmetric R-MAT graph ---------------------
    t0 = time.perf_counter()
    A_tiles = build_tiles(A_sym, tuned_partition_config(A_sym))
    lam_ref = float(scipy.sparse.linalg.eigsh(
        scipy.sparse.csr_matrix((A_sym.data, A_sym.indices, A_sym.indptr), shape=A_sym.shape),
        k=1, which="LA", return_eigenvectors=False)[0])
    for strategy in ("fused", "partials"):
        op = aslinearoperator(A_tiles, strategy=strategy, device=dev)
        res, rec = solve(f"power iteration rmat_graph(1 << 16) {strategy}",
                         lambda: power_iteration(op, tol=1e-6, maxiter=2000),
                         kernels=(SOLVER_KERNELS[strategy, False],), setup=1, per_step=2)
        lam = float(res.eigenvalue)
        check(abs(lam - lam_ref) <= 1e-4 * lam_ref,
              f"power iteration {strategy}: {lam} against eigsh {lam_ref}")
        log(f"[solvers] power iteration {strategy}: lambda {lam:.6f}, eigsh {lam_ref:.6f} "
            f"(rel diff {abs(lam - lam_ref) / lam_ref:.2e})")
        records.append(rec)
    del op, A_tiles
    log(f"[solvers] power iteration: {time.perf_counter() - t0:.1f} s")

    # --- the registry: measured search by CG time, then a PCG solve -------
    P = poisson2d(PCG_GRID)
    candidates = enumerate_configs(P.shape, row_blocks=(512,), col_blocks=(4096,),
                                   lanes=(8, 16, 32))
    reg = MatrixRegistry(device="cuda", cache_dir=cache, candidates=candidates,
                         probe=cg_probe(iters=10))
    plan = reg.admit(P, "poisson")
    check(plan.autotune_searched and len(plan.provenance["trials"]) == len(candidates),
          "the cg_probe search did not run")
    log(f"[solvers] registry admitted Poisson {PCG_GRID}^2 by cg_probe(iters=10) "
        f"({reg.probe.kind}) in {plan.preprocess_s:.1f} s: " + ", ".join(
            f"lane {t['config']['lane']}: {t['objective_us']} us"
            for t in plan.provenance["trials"]) + f"; chose {plan.cfg}")
    b = torch.randn(P.shape[0], device=dev, generator=g)
    _, rec = solve("CG plan.operator() M=plan.jacobi()",
                   lambda: cg(plan.operator(), b, tol=1e-5, maxiter=4000, M=plan.jacobi()),
                   kernels=("hbp_spmv_fused",), setup=1, per_step=1, A64=Float64Csr(P, dev),
                   b=b)
    records.append(rec)
    for rec in records:
        log("[solvers-json] " + json.dumps(rec))
    log(f"[solvers] kernel launches over the phase: {totals}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def telemetry_phase(kron, spec, reset_counts, read_counts, cache: str) -> dict:
    """Serve ``m4_kron16`` with obs enabled under ``"fused"`` and
    ``"partials"`` and read the telemetry back (see the module docstring,
    phase ``telemetry``).  Returns each kernel's launches in the phase."""
    import urllib.request

    from repro_torch import obs
    from repro_torch.analysis.diff import diff_artifacts, render_text
    from repro_torch.obs.attribution import attribution_rows, render_attribution
    from repro_torch.obs.export import parse_openmetrics, serve
    from repro_torch.obs.planview import explain_report
    from repro_torch.serving import MatrixRegistry, ServingEngine

    t_phase = time.perf_counter()
    kernels = {"fused": ("hbp_spmv_fused", "hbp_spmm_fused"),
               "partials": ("hbp_spmv_partials", "hbp_spmm_partials")}
    snaps, launched = {}, {}
    for strategy, names in kernels.items():
        obs.reset()
        obs.enable()
        try:
            registry = MatrixRegistry(device="cuda", cache_dir=cache, search=False,
                                      strategy=strategy)
            plan = registry.admit(kron, "m4_kron16")
            eng = ServingEngine(registry, max_batch=16, max_wait_s=0.0)
            xrng = np.random.default_rng(8)
            reset_counts()
            sent = []
            for size in (1, 16, 2, 11, 3, 8, 5, 16):  # 62 requests, batch widths 1..16
                for _ in range(size):
                    x = xrng.standard_normal(kron.shape[1]).astype(np.float32)
                    sent.append((x, eng.submit("m4_kron16", x)))
                eng.poll()
            eng.flush()
            counts = read_counts(names)
            launched.update(counts)
            for x, t in sent:
                y = t.result()
                check(y.shape == (kron.shape[0],) and np.all(np.isfinite(y)),
                      f"[telemetry] {strategy}: bad answer")
            # the served bits are plan.matvec's (the [serving] contract)
            for x, t in (sent[0], sent[-1]):
                check(np.array_equal(t.result(), plan.matvec(x).cpu().numpy()),
                      f"[telemetry] {strategy}: served answer != plan.matvec")
            # this registry's always-live counters beside the gated global
            # ones (kernel traffic, spans, requests) of this strategy alone
            snap = obs.collect()
            snap["registries"] = [obs.registry().collect(), registry.metrics.collect()]
            snaps[strategy] = snap
        finally:
            obs.disable()
        rows = attribution_rows(snap, hw=spec)
        check([(r["matrix"], r["strategy"]) for r in rows] == [("m4_kron16", strategy)],
              f"[telemetry] attribution rows {rows}")
        (row,) = rows
        check(row["launches"] == sum(counts.values()) > 0,
              f"[telemetry] {strategy}: {row['launches']} attributed launches, kernel "
              f"counters rose by {counts}")
        check(row["roofline_fraction"] is not None and row["roofline_fraction"] <= 1.05,
              f"[telemetry] {strategy}: roofline fraction {row['roofline_fraction']} above "
              "1.05 of the card's peak: the modeled byte count is wrong")
        for line in render_attribution(rows, hw=spec).splitlines():
            log(f"[telemetry] {line}")
        log(f"[telemetry] {strategy}: {row['launches']} flushes = kernel launches {counts}; "
            f"{row['bytes_modeled'] / 1e9:.3f} GB modeled in {row['measured_s'] * 1e3:.3f} ms "
            f"measured: {row['achieved_gbps']:.3f} GB/s, {100 * row['roofline_fraction']:.2f} % "
            f"of the {spec.name}'s {spec.hbm_bw / 1e12} TB/s")
        text = explain_report(snap, "m4_kron16", hw=spec)
        check(f"of {spec.name} HBM" in text, "[telemetry] explain does not name the card")
        for line in text.splitlines():
            log(f"[telemetry] {line}")
        # the loopback scrape gives the snapshot's attr.* values
        want = {(m["name"].replace(".", "_"), tuple(sorted(m["labels"].items()))): m["value"]
                for m in registry.metrics.collect()["metrics"] if m["name"].startswith("attr.")}
        with serve(port=0, addr="127.0.0.1", registries=[registry.metrics]) as srv:
            with urllib.request.urlopen(srv.url, timeout=30) as resp:
                fams = parse_openmetrics(resp.read().decode("utf-8"))
        got = {(fam, tuple(sorted(s["labels"].items()))): s["value"]
               for fam, f in fams.items() if fam.startswith("attr_") for s in f["samples"]}
        check(got == want, f"[telemetry] scrape {got} != snapshot {want}")
        log(f"[telemetry] {strategy}: the scrape of {srv.url} parses and gives the snapshot's "
            f"{len(want)} attr.* values")
        del eng, registry
    obs.reset()
    result = diff_artifacts(snaps["fused"], snaps["partials"])
    for line in render_text(result, top=8).splitlines():
        log(f"[telemetry] diff fused -> partials: {line}")
    log(f"[telemetry] phase: {time.perf_counter() - t_phase:.1f} s")
    return launched


def sharded_runs(csr, cfg, x_np: np.ndarray, dev) -> dict:
    """Both placements of ``csr`` over the current process group, on
    ``dev``: y of two calls and what each took (see phase ``distributed``)."""
    import torch.distributed as dist

    from repro_torch.core.distributed import MODES, build_sharded_spmv, shard_tiles

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    x = torch.as_tensor(x_np, device=dev)
    out, sh = {}, None
    for mode in MODES:
        t0 = time.perf_counter()
        if sh is None:
            sh = build_sharded_spmv(csr, cfg=cfg, mode=mode, device=dev)
        else:
            sh = shard_tiles(sh.tiles, mode=mode, device=dev)
        build_s = time.perf_counter() - t0
        before = K.hbp_spmv_partials.launches
        y1 = sh.matvec(x)
        y2 = sh.matvec(x)
        launches = K.hbp_spmv_partials.launches - before

        def wall_ms(fn, iters=20):
            fn()
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(dev)
            return (time.perf_counter() - t) / iters * 1e3

        part = torch.zeros(sh.tiles.n_rowgroups, sh.tiles.cfg.group, device=dev)
        out[mode] = {
            "y": y1.cpu().numpy(), "bitwise": bool(torch.equal(y1, y2)), "launches": launches,
            "loads": sh.loads.tolist(), "t_max": sh.t_max, "build_s": build_s,
            "matvec_ms": wall_ms(lambda: sh.matvec(x)),
            "kernel_ms": timed_ms(lambda: K.hbp_spmv_partials(sh.local, x), 20),
            "all_reduce_ms": wall_ms(lambda: dist.all_reduce(part)),
        }
    return out


def gloo_rank(rank: int, world: int, init: str, csr, cfg, x_np, path: str) -> None:
    """One rank of the gloo group on ``cuda:0``; writes its runs to ``path``."""
    import pickle

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        res = sharded_runs(csr, cfg, x_np, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    with open(path, "wb") as f:
        pickle.dump(res, f)


def distributed_phase(kron, cfg, dev) -> int:
    """``m4_kron16`` sharded under both placements: world 1 under NCCL in
    this process, world 2 under gloo in two processes on the same card
    (see the module docstring, phase ``distributed``).  Returns kernel 5's
    launches over every rank."""
    import multiprocessing
    import pickle

    import torch.distributed as dist

    t_phase = time.perf_counter()
    x_np = np.random.default_rng(9).standard_normal(kron.shape[1]).astype(np.float32)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        init = f"file://{tmp}/gloo_rendezvous"
        paths = [f"{tmp}/rank{r}.pkl" for r in range(2)]
        procs = [ctx.Process(target=gloo_rank, args=(r, 2, init, kron, cfg, x_np, paths[r]))
                 for r in range(2)]
        for p in procs:
            p.start()
        # world 1 under NCCL here while the gloo ranks start
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous",
                                world_size=1, rank=0)
        try:
            runs["nccl world 1"] = [sharded_runs(kron, cfg, x_np, dev)]
        finally:
            dist.destroy_process_group()
        for p in procs:
            p.join(timeout=600)
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            check(p.exitcode == 0, f"[distributed] gloo rank {r} exited with {p.exitcode}")
        gloo = []
        for path in paths:
            with open(path, "rb") as f:
                gloo.append(pickle.load(f))
        runs["gloo world 2 on cuda:0"] = gloo
        log(f"[distributed] both set-ups ran in {time.perf_counter() - t0:.1f} s")
    ref64 = Float64Csr(kron, dev)
    xd = torch.as_tensor(x_np, device=dev)[:, None]
    for setup, ranks in runs.items():
        for mode in ranks[0]:
            for r, res in enumerate(ranks):
                m = res[mode]
                what = f"[distributed] {setup} {mode} rank {r}"
                ref64.check(torch.as_tensor(m["y"], device=dev)[:, None], xd, what)
                check(m["bitwise"], f"{what}: two calls differ")
                check(np.array_equal(m["y"], ranks[0][mode]["y"]), f"{what}: y != rank 0's")
                check(m["launches"] == 2, f"{what}: kernel 5 launched {m['launches']} times "
                      "in two calls")
            loads = np.asarray(ranks[0][mode]["loads"])
            log(f"[distributed] {setup} {mode}: loads {loads.astype(int).tolist()} "
                f"(max/mean {loads.max() / loads.mean():.4f}), t_max {ranks[0][mode]['t_max']}; "
                + "; ".join(
                    f"rank {r}: shard built in {res[mode]['build_s']:.2f} s, matvec "
                    f"{res[mode]['matvec_ms']:.3f} ms, kernel 5 {res[mode]['kernel_ms']:.4f} ms, "
                    f"all_reduce {res[mode]['all_reduce_ms']:.3f} ms, kernel 5 launches "
                    f"{res[mode]['launches']}" for r, res in enumerate(ranks))
                + "; within 1e-5 * (|A| |x|) of float64, two calls bitwise equal")
    log(f"[distributed] phase: {time.perf_counter() - t_phase:.1f} s")
    return sum(res[mode]["launches"] for ranks in runs.values() for res in ranks for mode in res)


# --- the LM serving path ----------------------------------------------------

# The launcher's defaults (python -m repro_torch.launch.serve): 8 requests of
# 12 prompt tokens, 16 new tokens each, decode batch 4, cache of 256.
LM_ARCH = "olmo-1b"
LM_REQUESTS, LM_PROMPT, LM_NEW, LM_BATCH, LM_MAX_LEN = 8, 12, 16, 4, 256
LM_SPARSITY = 0.9
LM_WIDTHS = (1, 4, 48)  # one token, the decode batch, the prefill's 4 x 12


def lm_phase(dev, spec, smi_line, reset_counts, read_counts):
    """OLMo-1B at full width on the card (see the module docstring, phase
    ``lm``).  Returns the launches of kernels 1-2 during the pruned FFN
    projections' applies, and the served batches' peak memory with the
    bytes the earlier phases still held when the phase began."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.sparse_linear import SparseLinear, magnitude_prune
    from repro_torch.models import build_model, tree_map
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.nbytes for t in leaves)
    # the embedding table is padded to padded_vocab rows (50304 -> 50432)
    want = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    check(n_params == want and all(t.dtype == torch.bfloat16 for t in leaves),
          f"[lm] {n_params} parameters, expected {want} in bf16")
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded to "
        f"{cfg.padded_vocab}), {cfg.norm}, tied "
        f"{cfg.tie_embeddings}: {n_params} parameters, {weight_bytes} B in bf16, built on the "
        f"card in {time.perf_counter() - t0:.1f} s")

    # --- 1. serve 8 requests through the engine --------------------------
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32) for _ in range(LM_REQUESTS)]
    engine = Engine(model, params, EngineConfig(batch=LM_BATCH, max_len=LM_MAX_LEN), device=dev)
    engine.generate([Request(prompt=p.copy(), max_new=2) for p in prompts[:LM_BATCH]])  # warm-up
    events = {"prefill": [], "decode": []}

    def evented(fn, sink):
        def f(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            sink.append((start, end))
            return out
        return f

    engine._prefill = evented(engine._prefill, events["prefill"])
    engine._decode = evented(engine._decode, events["decode"])
    reqs = [Request(prompt=p.copy(), max_new=LM_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    outs = np.stack([r.out for r in reqs])
    check(outs.shape == (LM_REQUESTS, LM_NEW) and outs.min() >= 0 and outs.max() < cfg.vocab,
          f"[lm] bad tokens {outs.shape}")
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in events.items()}
    check(len(ms["prefill"]) == LM_REQUESTS // LM_BATCH and len(ms["decode"]) == LM_REQUESTS
          // LM_BATCH * LM_NEW, f"[lm] steps {[len(v) for v in ms.values()]}")
    prefill_ms, decode_ms = float(np.mean(ms["prefill"])), float(np.mean(ms["decode"]))
    decode_bound = weight_bytes / spec.hbm_bw * 1e3
    tokens = LM_REQUESTS * LM_NEW
    log(f"[lm] served {LM_REQUESTS} requests ({LM_PROMPT} prompt tokens, {LM_NEW} new each, "
        f"batch {LM_BATCH}, max_len {LM_MAX_LEN}) on {smi_line}: prefill {prefill_ms:.3f} ms "
        f"(mean of {len(ms['prefill'])}), decode {decode_ms:.3f} ms per step (mean of "
        f"{len(ms['decode'])}, min {min(ms['decode']):.3f}, max {max(ms['decode']):.3f}) against "
        f"a bound of {decode_bound:.3f} ms (the bf16 weights read once over the {spec.name}'s "
        f"{spec.hbm_bw / 1e12} TB/s); {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
        f"tok/s; peak memory {peak} B ({peak / 2**30:.2f} GiB); first tokens {outs[0, :8].tolist()}")
    # one more decode step under the profiler: the card's busy share of it
    cache = model.init_cache(LM_BATCH, LM_MAX_LEN, device=dev)
    cur = torch.as_tensor(outs[:LM_BATCH, :1], dtype=torch.int64, device=dev)
    step16 = make_decode_step(model)
    t0 = time.perf_counter()
    step16(engine.params, cache, cur, LM_PROMPT)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    _, busy_ms = kernel_device_ms(lambda: step16(engine.params, cache, cur, LM_PROMPT))
    busy = "not measured (no device time in the profile)" if busy_ms is None else (
        f"{busy_ms:.3f} ms of device time in all kernels ({busy_ms / host_ms:.1%} of the step's "
        f"{host_ms:.3f} ms host-clock time)")
    log(f"[lm] one decode step under torch.profiler: {busy}")
    del engine, cache

    # --- 2. cached decode against a full forward ---------------------------
    # Random weights drawn as the JAX package draws them (a 3-D attention
    # weight's "fan_in" is its head count: wq's sigma is 1/4) saturate the
    # softmax, so this random network amplifies rounding from layer to layer:
    # two f32 orders of summation part by far more than 1e-4 at this width.
    # The check therefore runs on a float64 copy of the weights, where the
    # rounding stays far below the tolerance; the f32 copy's deviations are
    # printed beside it.
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    V = cfg.vocab  # the padded columns hold -1e30
    seq = torch.as_tensor(np.concatenate([np.stack(prompts[:LM_BATCH]), outs[:LM_BATCH]], 1),
                          dtype=torch.int64, device=dev)  # [4, 28]

    def decode_against_full(dtype):
        """(worst |err| / max|logits| over the prefill's and the cached decode
        steps' logits, within the tolerance?, the full forward's logits)."""
        name = {torch.float32: "float32", torch.float64: "float64"}[dtype]
        m = build_model(dataclasses.replace(cfg, dtype=name))
        p = tree_map(lambda t: t.to(dtype), params)
        with torch.no_grad():
            full, _, _ = m.forward(p, {"tokens": seq})
        cache = m.init_cache(LM_BATCH, LM_MAX_LEN, device=dev)
        cache, last = make_prefill_step(m)(p, {"tokens": seq[:, :LM_PROMPT]}, cache)
        worst, ok = 0.0, True
        for s in range(LM_NEW):
            pos = LM_PROMPT - 1 + s
            want = full[:, pos, :V]
            check(bool(torch.all(last[:, V:] == -1e30)), f"[lm] {name} step {s}: padded columns")
            err = (last[:, :V] - want).abs()
            ok &= bool(torch.all(err <= 1e-4 * want.abs() + 1e-4 * want.abs().max()))
            worst = max(worst, err.max().item() / want.abs().max().item())
            if s + 1 < LM_NEW:
                cache, _, last = make_decode_step(m)(p, cache, seq[:, pos + 1 : pos + 2], pos + 1)
        return worst, ok, full[..., :V]

    worst64, ok64, full64 = decode_against_full(torch.float64)
    check(ok64, f"[lm] float64 cached decode disagrees with the full forward (worst {worst64:.3e})")
    worst32, ok32, full32 = decode_against_full(torch.float32)
    drift = ((full32 - full64).abs().max() / full64.abs().max()).item()
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    log(f"[lm] float64 copy: the prefill's and {LM_NEW - 1} cached decode steps' logits equal a "
        f"full forward over the same {seq.shape[1]} tokens within rtol=1e-4, atol=1e-4 * "
        f"max|logits| over the {V} real columns (worst |err| / max|logits| {worst64:.2e}); the "
        f"float32 copy (TF32 off, not gated): worst {worst32:.2e} ({'within' if ok32 else 'outside'}"
        f" the tolerance), its full forward {drift:.2e} of max|logits| from float64's")
    del full64, full32

    # --- 3. prune and admit every FFN projection --------------------------
    t0 = time.perf_counter()
    layers = []  # (name, SparseLinear, pruned W as f64 on the card)
    stack = params["dec"]["stack"]["l0"]["ffn"]
    for g in range(cfg.n_layers):
        for name in ("wg", "w1", "w2"):
            w = stack[name][g].float().T.contiguous().cpu().numpy()  # [out, in]
            layer = SparseLinear.from_dense(w, sparsity=LM_SPARSITY, device=dev)
            pruned = torch.as_tensor(magnitude_prune(w, LM_SPARSITY), device=dev)
            layers.append((f"l{g}.{name}", layer, pruned))
    build_s = time.perf_counter() - t0
    dens = [l.density() for _, l, _ in layers]
    occ = [l.tiles.nnz_utilization() for _, l, _ in layers]
    stream = layers[0][1].tiles.data.nbytes + layers[0][1].tiles.cols.nbytes
    log(f"[lm] pruned {len(layers)} FFN projections (wg, w1, w2 of {cfg.n_layers} layers) to "
        f"sparsity {LM_SPARSITY} and admitted them in {build_s:.1f} s on the host (prune, CSR, "
        f"tiles at row_block 256 / col_block 512, staging): mean density {np.mean(dens):.4f}; "
        f"{layers[0][1].tiles.n_tiles} tiles of {layers[0][1].tiles.cfg.group} x "
        f"{layers[0][1].tiles.cfg.lane} each, slot occupancy {min(occ):.3f}-{max(occ):.3f}; one "
        f"matrix's tile stream (f32 data + i32 cols) {stream} B beside {w.size * 2} B of dense bf16")

    # --- 4. each projection against the pruned dense product ---------------
    g_lm = torch.Generator(device=dev).manual_seed(9)
    reset_counts()
    worst = {k: 0.0 for k in LM_WIDTHS}
    for label, layer, pruned in layers:
        plain = dataclasses.replace(layer, backend="torch")
        w64 = pruned.double()
        for k in LM_WIDTHS:
            x = torch.randn(k, layer.in_features, device=dev, generator=g_lm)
            y = layer.apply(x)
            check(y.shape == (k, layer.out_features) and y.dtype == torch.float32,
                  f"[lm] {label} k={k}: {tuple(y.shape)} {y.dtype}")
            bound = RTOL * (x.double().abs() @ w64.abs().T) + 1e-30
            err = (y.double() - x.double() @ w64.T).abs()
            check(bool(torch.all(err <= bound)),
                  f"[lm] {label} k={k}: disagrees with the pruned dense product")
            check(bool(torch.all((y.double() - plain.apply(x).double()).abs() <= bound)),
                  f"[lm] {label} k={k}: disagrees with its plain version")
            worst[k] = max(worst[k], float((err / bound).max()))
            if k == 4:
                for i in range(k):
                    check(torch.equal(layer.apply(x[i]), y[i]),
                          f"[lm] {label}: the SpMM column {i} is not the SpMV")
    counts = read_counts(("hbp_spmv_fused", "hbp_spmm_fused"))
    check(all(n > 0 for n in counts.values()), f"[lm] kernels 1-2 did not launch: {counts}")
    log(f"[lm] every projection at k={list(LM_WIDTHS)} within 1e-5 * (|x| |W_pruned|^T) of the "
        f"pruned dense product and of its plain version (backend='torch' on the card); worst "
        f"|err| / bound {', '.join(f'k={k}: {v:.3f}' for k, v in worst.items())}; k=4 SpMM "
        f"columns bit for bit the per-token SpMVs; launches {counts}")

    # --- 5. times: the pruned layer beside the dense and CSR products -------
    for label, layer, pruned in (layers[1], layers[2]):  # l0.w1 [8192, 2048], l0.w2 [2048, 8192]
        plain = dataclasses.replace(layer, backend="torch")
        dense16 = pruned.to(torch.bfloat16)  # the same matrix, dense, as served
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
            csr = pruned.to_sparse_csr()
        for k in (1, 4):
            x = torch.randn(k, layer.in_features, device=dev, generator=g_lm)
            x16, xt = x.to(torch.bfloat16), x.T.contiguous()
            name = "hbp_spmv_fused" if k == 1 else "hbp_spmm_fused"
            arg = x[0].contiguous() if k == 1 else xt
            row = {
                "layer": label, "shape": [layer.out_features, layer.in_features], "k": k,
                "kernel_ms": timed_ms(lambda: getattr(K, name)(layer.dt, arg), 50),
                "apply_ms": timed_ms(lambda: layer.apply(x), 50),
                "plain_ms": timed_ms(lambda: plain.apply(x), 10),
                "dense_bf16_ms": timed_ms(lambda: x16 @ dense16.T, 50),
                "dense_f32_ms": timed_ms(lambda: x @ pruned.T, 50),
                "csr_ms": timed_ms(lambda: csr @ xt, 50),
                "bound_ms": kernel_bytes(name, layer.dt, k) / spec.hbm_bw * 1e3,
                "dense_bf16_bound_ms": (dense16.nbytes + (x16.nbytes + k * layer.out_features
                                                          * 2)) / spec.hbm_bw * 1e3,
                "card": smi_line,
            }
            log("[lm-times] " + json.dumps(row))
    log(f"[lm] phase took {time.perf_counter() - t_phase:.1f} s")
    del layers, params
    torch.cuda.empty_cache()
    return counts, {"peak": peak, "base": base}


# [lm-train]: OLMo-1B trained through Trainer with the launcher's AdamW
# defaults at 8 steps (python -m repro_torch.launch.train --steps 8)
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 8, 8, 1024, 2
LM_TRAIN_LAYERS_CHECKED = 2  # the float64, equivalence and restart checks
LM_RESTART_AT = 3  # of 6 steps
# the H100 SXM's published dense bf16 rate (NVIDIA data sheet), for the
# model FLOP/s share
H100_SXM_BF16_FLOPS = 989e12
# One train step against another (float32 against float64, two
# microbatches against one), leaf by leaf.  Random weights drawn as the JAX
# package draws them saturate attention, which makes single gradient
# elements chaotic (worse with depth; scripts/lm_train_chaos.py), so the
# gradients are held in norm: the first moment (0.1 * the clipped gradient)
# within STEP_TOL[...] relative L2 error.  AdamW's first step moves a weight
# by lr * sign(g): an element whose gradient lies within its error of zero
# may step the other way, 2 * lr apart.  So every parameter must lie within
# 2 * lr, the update's sign may differ on at most tol / 10 of a leaf, and
# the update (p - p0) within 10 * tol relative L2 error (2 sqrt(tol / 10)
# from the sign changes alone).
STEP_TOL = {"float64": 1e-2, "microbatches": 1e-4}
# float32 against float64: loss and grad norm (relative)
F64_LOSS_RTOL, F64_GNORM_RTOL = 1e-4, 1e-3
# one microbatch against two: loss and grad norm (relative)
MICRO_LOSS_RTOL, MICRO_GNORM_RTOL = 1e-5, 1e-4


def step_stats(got, want, base) -> list:
    """Per leaf, for two train states taken one step from the parameters
    ``base``: the first moment's relative L2 error, the update's, the share
    of update signs that differ, and the largest parameter difference."""
    from repro_torch.optim.adamw import tree_leaves

    rows = []
    for a, b, ma, mb, p0 in zip(tree_leaves(got["params"]), tree_leaves(want["params"]),
                                tree_leaves(got["opt"]["m"]), tree_leaves(want["opt"]["m"]),
                                tree_leaves(base)):
        a, b, p0 = a.double(), b.double(), p0.double()
        da, db = a - p0, b - p0
        rows.append({
            "shape": tuple(b.shape),
            "m_rel": ((ma.double() - mb.double()).norm() / mb.double().norm()).item(),
            "update_rel": ((da - db).norm() / db.norm()).item(),
            "flips": ((torch.sign(da) != torch.sign(db)) & (db != 0)).double().mean().item(),
            "max_err": (a - b).abs().max().item(),
        })
    return rows


def step_agrees(got, want, base, lr: float, which: str) -> dict:
    """Check the rule above; returns the worst figure of each kind."""
    tol = STEP_TOL[which]
    rows = step_stats(got, want, base)
    for r in rows:
        check(r["m_rel"] <= tol and r["update_rel"] <= 10 * tol and r["flips"] <= tol / 10
              and r["max_err"] <= 2 * lr, f"[lm-train] {which}: a leaf {r['shape']} disagrees: "
              f"first moment rel L2 {r['m_rel']:.3e}, update rel L2 {r['update_rel']:.3e}, sign "
              f"changes {r['flips']:.3e}, max |err| {r['max_err']:.3e} (lr {lr:.3e}, tol {tol})")
    return {key: max(r[key] for r in rows) for key in ("m_rel", "update_rel", "flips", "max_err")}


def flat_paths(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_paths(sub, f"{prefix}/{key}" if prefix else key).items()}
    return {prefix: tree}


def lm_train_phase(dev, smi_line) -> dict:
    """OLMo-1B trained on the card (see the module docstring, phase
    ``lm-train``).  Returns the f32 run's peak memory with the bytes the
    earlier phases still held when it began."""
    import dataclasses
    import shutil
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
    from repro_torch.models import build_model, tree_map
    from repro_torch.models.params import dtype_of
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    steps = LM_TRAIN_STEPS
    opt = adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH, seed=0)
    train_cfg = TrainerConfig(steps=steps, log_every=1, checkpoint_every=steps,
                              n_microbatch=LM_TRAIN_MICRO, remat=True)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ

    def run_trainer(model, opt_cfg, tc, state=None):
        """(trainer, final state, per-step CUDA-event ms, wall s, peak B)."""
        trainer = Trainer(model, opt_cfg, data, tc, device=dev)
        events = []
        step_fn = trainer.step_fn

        def evented(st, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(st, batch)
            end.record()
            events.append((start, end))
            return out

        trainer.step_fn = evented
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer.step_fn = step_fn
        return (trainer, state, [s.elapsed_time(e) for s, e in events], wall,
                torch.cuda.max_memory_allocated())

    # --- 1. full width and depth, 8 steps, two microbatches, remat --------
    model = build_model(cfg)
    adamw.update_per_layer.leaves = 0
    base32 = torch.cuda.memory_allocated()
    trainer, state, ms, wall, peak32 = run_trainer(model, opt, train_cfg)
    hist = trainer.history
    leaves = adamw.tree_leaves(state["params"])
    n_params = sum(t.numel() for t in leaves)
    # the embedding table is padded to padded_vocab rows (50304 -> 50432)
    want = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    check(n_params == want and all(t.dtype == torch.bfloat16 for t in leaves),
          f"[lm-train] {n_params} parameters, expected {want} in bf16")
    check(len(hist) == steps and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                     for r in hist), f"[lm-train] bad history {hist}")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"[lm-train] the loss did not fall: {[r['loss'] for r in hist]}")
    # the leaves that take the per-layer update: w1, wg and w2, each a
    # [16, 2048, 8192] stack of 268 M elements
    giants = sorted(k for k, v in flat_paths(state["params"]).items()
                    if v.ndim >= 2 and v.numel() > adamw._SCAN_LIMIT)
    per_layer = adamw.update_per_layer.leaves
    check(giants == ["dec/stack/l0/ffn/w1", "dec/stack/l0/ffn/w2", "dec/stack/l0/ffn/wg"]
          and per_layer == len(giants) * steps,
          f"[lm-train] per-layer AdamW updates {per_layer} over {giants}")
    step_ms = statistics.median(ms[1:])
    # model FLOPs: 6 N per token, plus the attention products the code
    # computes (QK^T and PV over the full S x S scores, forward 4 B S^2 d a
    # layer, backward twice that); remat's recomputation is not counted
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * LM_TRAIN_BATCH * LM_TRAIN_SEQ ** 2 \
        * cfg.d_model
    tflops = flops / (step_ms / 1e3) / 1e12
    batch = trainer._batch(steps)
    kernels = device_kernel_ms(lambda: trainer.step_fn(state, batch))
    busy_ms = sum(kernels.values())
    busy = "not measured (no device time in the profile)" if not kernels else (
        f"{busy_ms:.3f} ms of device time in all kernels, {busy_ms / step_ms:.1%} of the median "
        f"step; the top kernels: " + "; ".join(
            f"{name[:60]} {ms:.1f} ms" for name, ms in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:8]))
    log(f"[lm-train] {LM_ARCH} at full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16, "
        f"{n_params} parameters): {steps} steps of a global batch {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} in {LM_TRAIN_MICRO} microbatches, remat (two-level), AdamW f32 moments "
        f"(lr {opt.lr_peak}, warmup {opt.warmup_steps}, decay {opt.decay_steps}) on {smi_line}")
    log(f"[lm-train] losses {[round(r['loss'], 4) for r in hist]}; grad norms "
        f"{[round(r['grad_norm'], 4) for r in hist]}")
    log(f"[lm-train] step ms {[round(x, 1) for x in ms]}; median of steps 2-{steps} "
        f"{step_ms:.1f} ms = {tokens / step_ms * 1e3:.0f} tokens/s, {tflops:.1f} TFLOP/s of model "
        f"FLOPs ({flops:.4e} a step; {tflops * 1e12 / H100_SXM_BF16_FLOPS:.1%} of the H100 "
        f"SXM's 989 TFLOP/s bf16); {wall:.1f} s for the run; peak memory {peak32} B "
        f"({peak32 / 2**30:.2f} GiB); per-layer AdamW updates {per_layer} (the FFN stacks, "
        f"3 a step); one step under torch.profiler: {busy}")
    del trainer, state, batch
    torch.cuda.empty_cache()

    # --- 2. int8 moments, 2 steps at full depth ----------------------------
    opt8 = dataclasses.replace(opt, state_dtype="int8")
    trainer, state, ms8, _, peak8 = run_trainer(model, opt8, dataclasses.replace(
        train_cfg, steps=2))
    check(all(np.isfinite(r["loss"]) for r in trainer.history), "[lm-train] int8: bad loss")
    log(f"[lm-train] int8 moments: 2 steps, losses {[round(r['loss'], 4) for r in trainer.history]}"
        f", step ms {[round(x, 1) for x in ms8]}, peak memory {peak8} B ({peak8 / 2**30:.2f} GiB) "
        f"beside {peak32} B ({peak32 / 2**30:.2f} GiB) with f32 moments")
    del trainer, state, model
    torch.cuda.empty_cache()

    # --- 3. at 2 layers: float64, remat, microbatches, restart ------------
    cfg2 = dataclasses.replace(cfg, n_layers=LM_TRAIN_LAYERS_CHECKED)
    base = build_model(cfg2).init(torch.Generator().manual_seed(1), device=dev)
    batch = make_global_batch(SyntheticLM(data), 0, dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.use_deterministic_algorithms(True, warn_only=True)

    def one_step(dtype: str, n_micro: int, remat: bool):
        c = dataclasses.replace(cfg2, dtype=dtype)
        params = tree_map(lambda t: t.to(dtype_of(c)), base)
        st = {"params": params, "opt": adamw.init_opt_state(params, opt)}
        new, metrics = make_train_step(build_model(c), opt, n_microbatch=n_micro,
                                       remat=remat)(st, batch)
        return new, {k: float(v) for k, v in metrics.items()}

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s64, m64 = one_step("float64", LM_TRAIN_MICRO, True)
        s32, m32 = one_step("float32", LM_TRAIN_MICRO, True)
        lr = m64["lr"]
        loss_err = abs(m32["loss"] - m64["loss"]) / abs(m64["loss"])
        gnorm_err = abs(m32["grad_norm"] - m64["grad_norm"]) / m64["grad_norm"]
        check(loss_err <= F64_LOSS_RTOL and gnorm_err <= F64_GNORM_RTOL,
              f"[lm-train] float32 step against float64: loss {m32['loss']} vs {m64['loss']}, "
              f"grad norm {m32['grad_norm']} vs {m64['grad_norm']}")
        f64 = step_agrees(s32, s64, base, lr, "float64")
        log(f"[lm-train] {LM_TRAIN_LAYERS_CHECKED} layers at full width, one step (TF32 off): "
            f"float32 against float64 loss {m32['loss']:.8f} / {m64['loss']:.8f} (rel err "
            f"{loss_err:.2e}), grad norm {m32['grad_norm']:.6e} / {m64['grad_norm']:.6e} (rel err "
            f"{gnorm_err:.2e}); worst leaf: first moment rel L2 {f64['m_rel']:.2e}, update rel L2 "
            f"{f64['update_rel']:.2e}, update sign changes {f64['flips']:.2e}, max |err| "
            f"{f64['max_err']:.2e} (lr {lr:.2e}; AdamW's update is f32 in both)")
        del s64
        s_plain, m_plain = one_step("float32", LM_TRAIN_MICRO, False)
        remat_same = all(torch.equal(a, b) for a, b in zip(
            adamw.tree_leaves(s32), adamw.tree_leaves(s_plain)))
        remat_diff = max((a.double() - b.double()).abs().max().item() for a, b in zip(
            adamw.tree_leaves(s32["params"]), adamw.tree_leaves(s_plain["params"])))
        del s_plain
        s_one, m_one = one_step("float32", 1, True)
        micro_loss = abs(m_one["loss"] - m32["loss"]) / abs(m_one["loss"])
        micro_gnorm = abs(m_one["grad_norm"] - m32["grad_norm"]) / m_one["grad_norm"]
        check(micro_loss <= MICRO_LOSS_RTOL and micro_gnorm <= MICRO_GNORM_RTOL,
              f"[lm-train] 2 microbatches against 1: loss {m32['loss']} vs {m_one['loss']}, "
              f"grad norm {m32['grad_norm']} vs {m_one['grad_norm']}")
        micro = step_agrees(s32, s_one, base, lr, "microbatches")
        del s32, s_one

        # restart: 6 steps straight against 3, a checkpoint, a fresh Trainer
        model2 = build_model(cfg2)
        tc = dataclasses.replace(train_cfg, steps=2 * LM_RESTART_AT, log_every=100)
        _, straight, _, _, _ = run_trainer(model2, opt, tc)
        ckdir = tempfile.mkdtemp(prefix="lm_train_ckpt_")
        tc_mid = dataclasses.replace(tc, steps=LM_RESTART_AT, checkpoint_every=100,
                                     checkpoint_dir=ckdir)
        run_trainer(model2, opt, tc_mid)
        _, resumed, _, _, _ = run_trainer(model2, opt, dataclasses.replace(
            tc_mid, steps=2 * LM_RESTART_AT))
        shutil.rmtree(ckdir)
        restart_same = all(torch.equal(a, b) for a, b in zip(
            adamw.tree_leaves(straight), adamw.tree_leaves(resumed)))
        restart_diff = max((a.double() - b.double()).abs().max().item() for a, b in zip(
            adamw.tree_leaves(straight["params"]), adamw.tree_leaves(resumed["params"])))
        del straight, resumed
    torch.use_deterministic_algorithms(False)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    # ops that have no deterministic CUDA implementation warn under warn_only
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic implementation" in str(w.message)})
    if nondet:
        log(f"[lm-train] no deterministic CUDA implementation: {nondet}; remat max |diff| "
            f"{remat_diff:.3e}, restart max |diff| {restart_diff:.3e} (not bit for bit)")
        check(remat_diff <= 2 * lr and restart_diff <= 2 * tc.steps * opt.lr_peak,
              "[lm-train] remat or restart differ by more than the update")
    else:
        check(remat_same, f"[lm-train] remat changed the step (max |diff| {remat_diff:.3e})")
        check(restart_same, f"[lm-train] a resumed run differs from a straight one (max |diff| "
              f"{restart_diff:.3e})")
    log(f"[lm-train] under torch.use_deterministic_algorithms: remat=True against False "
        f"{'bit for bit' if remat_same else f'max |diff| {remat_diff:.3e}'}; {LM_TRAIN_MICRO} "
        f"microbatches against 1: loss rel err {micro_loss:.2e}, grad norm rel err "
        f"{micro_gnorm:.2e}, worst leaf: first moment rel L2 {micro['m_rel']:.2e}, update rel L2 "
        f"{micro['update_rel']:.2e}, sign changes {micro['flips']:.2e}; "
        f"{2 * LM_RESTART_AT} steps straight against {LM_RESTART_AT}, a checkpoint and a resume "
        f"in a fresh Trainer: {'bit for bit' if restart_same else f'max |diff| {restart_diff:.3e}'}"
        f" (parameters and moments)")
    del base, batch
    torch.cuda.empty_cache()
    log(f"[lm-train] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"peak": peak32, "base": base32}


# [dryrun]: the predicted peaks may lie this far from the measured ones,
# either way; the sweep runs one shape per arch (decode_32k: a full sweep
# takes far longer than the phase's 90 s)
DRYRUN_TOL = 0.15
DRYRUN_SWEEP_SHAPE = "decode_32k"


def dryrun_phase(spec, smi_line, lm_memory: dict, train_memory: dict) -> None:
    """The dry run on the 1x1 host mesh (see the module docstring, phase
    ``dryrun``)."""
    import torch.distributed as dist

    from repro_torch.analysis.report import fleet_stats
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import mesh_shape
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    mesh = make_host_mesh("cuda")
    log(f"[dryrun] host mesh {mesh_shape(mesh)} on {mesh.device_type} (a world-1 NCCL group)")
    cfg = get_config(LM_ARCH)
    steps = LM_TRAIN_STEPS
    # [lm-train]'s step: its AdamW (f32 moments), microbatches and remat
    opt = AdamWConfig(lr_peak=3e-4, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    cells = (
        ("train", ShapeConfig("lm_train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"),
         dict(n_micro=LM_TRAIN_MICRO, ocfg=opt), train_memory, "[lm-train] f32 run"),
        ("decode", ShapeConfig("lm_decode", LM_MAX_LEN, LM_BATCH, "decode"), {}, lm_memory,
         "[lm] served batches"),
    )
    for label, shape, kw, measured, phase in cells:
        rec = dryrun.dryrun_cell(cfg, shape, mesh, hw=spec, device="cuda", roofline=False, **kw)
        check(rec["status"] == "ok", f"[dryrun] {label}: {rec}")
        predicted = rec["memory"]["peak_estimate_bytes"]
        held = measured["peak"] - measured["base"]
        ratio = predicted / held
        log(f"[dryrun] {LM_ARCH} {label} ({shape.global_batch} x {shape.seq_len}"
            f"{', %d microbatches, remat, AdamW f32' % LM_TRAIN_MICRO if label == 'train' else ''}"
            f"): predicted peak {predicted} B ({predicted / 2**30:.3f} GiB; arguments "
            f"{rec['memory']['argument_bytes']}, temp {rec['memory']['temp_bytes']}, output "
            f"{rec['memory']['output_bytes']}, alias {rec['memory']['alias_bytes']}; trace "
            f"{rec['compile_s']} s) beside {phase}' torch.cuda.max_memory_allocated() "
            f"{measured['peak']} B less the {measured['base']} B the earlier phases held = "
            f"{held} B: ratio {ratio:.4f} on {smi_line}")
        check(abs(ratio - 1) <= DRYRUN_TOL,
              f"[dryrun] {label}: predicted {predicted} B lies {ratio - 1:+.1%} from the measured "
              f"{held} B (tolerance {DRYRUN_TOL:.0%})")
    dist.destroy_process_group()

    t0 = time.perf_counter()
    recs = {}
    with tempfile.TemporaryDirectory() as out:
        for arch in sorted(ARCHS):
            for mesh_name in ("single", "multipod"):
                rec = dryrun.run_cell(arch, DRYRUN_SWEEP_SHAPE, mesh_name, Path(out), hw=spec,
                                      device="cuda", roofline=mesh_name == "single")
                check(rec["status"] in ("ok", "skipped"),
                      f"[dryrun] {arch} x {DRYRUN_SWEEP_SHAPE} x {mesh_name}: {rec.get('error')}")
                recs[arch, DRYRUN_SWEEP_SHAPE, mesh_name] = rec
    log(f"[dryrun] sweep of {DRYRUN_SWEEP_SHAPE} over {len(ARCHS)} archs on single and multipod "
        f"in {time.perf_counter() - t0:.1f} s: " + fleet_stats(recs))
    for (arch, _, mesh_name), rec in sorted(recs.items()):
        if rec["status"] == "ok":
            log(f"[dryrun] {arch} {mesh_name}: peak {rec['memory']['peak_estimate_bytes']} B, "
                f"fits {rec['fits_hbm']}, trace {rec['compile_s']} s"
                + (f", bound by {rec['roofline']['bottleneck']}" if "roofline" in rec else ""))
    log(f"[dryrun] phase took {time.perf_counter() - t_phase:.1f} s")


# --- the LM on a mesh of ranks -----------------------------------------------

# [mesh]: each model's train step on a (2, 2) ("data", "model") mesh of 4
# gloo ranks on cuda:0.  The sequence is 512, not [lm-train]'s 1024: four
# ranks share one card beside the phase's process.  Each model at full
# width; float32 at the depth given (None: all of it), float64 at
# MESH_F64_LAYERS.  OLMo-1B's float32 pass is cut from 16 layers to 4 and
# mamba2-370m's from 48 to 12 to keep the phase inside chip_smoke.py's
# time; granite-moe-1b-a400m runs all 24.
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_MODELS = (("olmo-1b", 4), ("granite-moe-1b-a400m", None), ("mamba2-370m", 12))
MESH_BATCH, MESH_SEQ, MESH_MICRO, MESH_STEPS = 8, 512, 2, 2
MESH_F64_LAYERS = 2  # the float64 gate's depth (full width)
# The 2 x 2 step against the world-1 step.  In float64 the loss is held to
# 1e-9; AdamW (in both packages) casts the gradients to float32 and takes
# the grad norm and the update in float32, so the grad norm and every leaf
# after 2 steps (relative to the leaf's largest) are held to float32's
# rounding, 1e-6: a gradient on the wrong shard moves a weight by up to
# 2 * lr, some 1e-2 of a leaf's largest.  In float32, each step's loss
# within 1e-3.  An MoE model's float64 routes (the top-k experts of every
# token in every layer, forward and rematerialised, of the first step) must
# equal world 1's: none may differ.
MESH_F64_LOSS_RTOL, MESH_F64_RTOL, MESH_F32_LOSS_RTOL = 1e-9, 1e-6, 1e-3
MESH_ADAMW = dict(lr_peak=3e-4, warmup_steps=1, decay_steps=MESH_STEPS)


def mesh_config(arch: str, dtype: str, layers=None, smoke: bool = False):
    """``arch`` (``smoke``: its CPU-test config, a try-out of the phase) in
    ``dtype`` at ``layers`` (default: all; never more than the config's)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    return dataclasses.replace(cfg, dtype=dtype, n_layers=min(layers or cfg.n_layers,
                                                              cfg.n_layers))


def mesh_data(cfg):
    from repro_torch.data import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MESH_SEQ, global_batch=MESH_BATCH,
                                  seed=0))


def mesh_steps(model, params, data, steps: int, dev, mesh=None, comm_step=None):
    """``steps`` train steps of ``model`` from ``params`` on ``data`` (on
    ``mesh``'s ranks under ``TRAIN_RULES`` with ``param_shardings``, or on
    world 1): (state, metrics per step, host ms per step, collective counts
    of step ``comm_step``, the MoE routes of the first step)."""
    import contextlib

    from repro_torch.data import make_global_batch
    from repro_torch.models.moe import record_routes
    from repro_torch.models.params import TRAIN_RULES, NamedSharding, sharding_ctx, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train import make_train_step

    opt = AdamWConfig(**MESH_ADAMW)
    named = None if mesh is None else tree_map(lambda s: NamedSharding(mesh, s),
                                                model.specs(TRAIN_RULES, mesh))
    step_fn = make_train_step(model, opt, n_microbatch=MESH_MICRO, remat=True,
                              param_shardings=named)
    state = {"params": params, "opt": init_opt_state(params, opt)}
    ctx = contextlib.nullcontext() if mesh is None else sharding_ctx(mesh, TRAIN_RULES)
    metrics, ms, counts, routes = [], [], {}, []
    with ctx:
        for i in range(steps):
            batch = (make_global_batch(data, i, dev) if mesh is None
                     else make_global_batch(data, i, mesh=mesh))
            comm = contextlib.nullcontext()
            if i == comm_step:
                from torch.distributed.tensor.debug import CommDebugMode

                comm = CommDebugMode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with comm, (record_routes() if i == 0 else contextlib.nullcontext()) as got:
                state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == comm_step:
                counts = {str(op): n for op, n in comm.get_comm_counts().items()}
            if i == 0:
                routes = [r.cpu() for r in got]
    return state, metrics, ms, counts, routes


def mesh_rank(rank: int, world: int, init: str, tmp: str, archs, smoke: bool) -> None:
    """One rank of ``[mesh]`` on ``cuda:0``: for each model, the float32
    steps, then the float64 steps at 2 layers, their checkpoint and (MoE)
    their routes; writes its figures to ``tmp/rank<rank>.json``.  No failure
    is caught: a rank that raises exits non-zero."""
    import hashlib

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import (
        TRAIN_RULES,
        NamedSharding,
        collective_route,
        logical_spec,
        place,
        placements,
        tree_map,
    )
    from repro_torch.optim.adamw import tree_leaves

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cuda")
        res = {"rank": rank, "coord": mesh.get_coordinate(), "route": collective_route(mesh)}

        def placed(model):
            # every rank draws the same weights; rank 0's are scattered
            full = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
            named = tree_map(lambda s: NamedSharding(mesh, s), model.specs(TRAIN_RULES, mesh))
            return tree_map(place, full, named)

        for arch, layers in archs:
            out = res[arch] = {}
            # --- float32 -------------------------------------------------
            cfg32 = mesh_config(arch, "float32", layers, smoke)
            model = build_model(cfg32)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            params = placed(model)
            torch.cuda.reset_peak_memory_stats()  # the steps' peak, not the weights' draw
            state, metrics, ms, _, _ = mesh_steps(model, params, mesh_data(cfg32), MESH_STEPS,
                                                  dev, mesh)
            out.update(f32_metrics=metrics, f32_ms=ms, peak=torch.cuda.max_memory_allocated(),
                       base=base)
            out["placement_mismatches"] = [
                str(leaf.placements) for leaf, d in zip(tree_leaves(state["params"]),
                                                        tree_leaves(model.defs))
                if leaf.placements != placements(logical_spec(d.shape, d.logical, TRAIN_RULES,
                                                              mesh), mesh)]
            out["n_leaves"] = len(tree_leaves(model.defs))
            del state, params
            torch.cuda.empty_cache()

            # --- 2 layers, float64, the checkpoint and the routes --------
            model = build_model(mesh_config(arch, "float64", MESH_F64_LAYERS, smoke))
            state, metrics, ms, counts, routes = mesh_steps(
                model, placed(model), mesh_data(cfg32), MESH_STEPS, dev, mesh,
                comm_step=MESH_STEPS - 1)
            out.update(f64_metrics=metrics, f64_ms=ms, comm_counts=counts)
            if routes:
                routes_path = f"{tmp}/{arch}_routes{rank}.pt"
                torch.save(routes, routes_path)
                out["routes"] = routes_path
            t0 = time.perf_counter()
            Checkpointer(f"{tmp}/{arch}_ckpt").save(MESH_STEPS, state, blocking=True)
            out["save_s"] = time.perf_counter() - t0
            out["local_sha256"] = [
                [str(leaf.placements) if isinstance(leaf, DTensor) else "()",
                 hashlib.sha256((leaf.to_local() if isinstance(leaf, DTensor) else leaf)
                                .contiguous().cpu().numpy().tobytes()).hexdigest()]
                for leaf in tree_leaves(state)]
            del state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def local_shard(full: torch.Tensor, spec_placements: str, coord, shape) -> torch.Tensor:
    """The shard of ``full`` a rank at ``coord`` holds under the placements
    printed as ``spec_placements`` (``Shard(dim=d)`` / ``Replicate()`` per
    mesh dim, split in mesh order as DTensor splits)."""
    import re

    out = full
    for i, p in enumerate(re.findall(r"Shard\(dim=(\d+)\)|Replicate\(\)", spec_placements)):
        if p:
            out = torch.chunk(out, shape[i], dim=int(p))[coord[i]]
    return out


def leaf_paths(tree, prefix=""):
    """The paths of a tree's leaves in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def mesh_world1(arch: str, layers, dev, smoke: bool):
    """The world-1 references of one model, computed on ``dev`` and freed:
    the float32 steps' metrics and ms; the float64 steps' metrics, final
    state (on the host) and first-step routes."""
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_flatten

    def run(cfg):
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        return mesh_steps(model, params, mesh_data(cfg), MESH_STEPS, dev)

    _, ref32, ms32, _, _ = run(mesh_config(arch, "float32", layers, smoke))
    state64, ref64, _, _, routes = run(mesh_config(arch, "float64", MESH_F64_LAYERS, smoke))
    leaves, rebuild = tree_flatten(state64)
    tree64 = rebuild([t.cpu() for t in leaves])
    del state64, leaves
    torch.cuda.empty_cache()
    return dict(ref32=ref32, ms32=ms32, ref64=ref64, tree64=tree64, routes=routes)


def mesh_phase(dev, spec, smi_line, *, smoke: bool = False, after=None, archs=None) -> None:
    """Each model's train step on a 2 x 2 mesh of gloo ranks on ``cuda:0``
    (see the module docstring, phase ``mesh``); ``smoke`` runs the CPU
    tests' configs, a try-out (``scripts/mesh_phase.py --smoke``), and
    ``archs`` a subset of ``MESH_MODELS`` (``--arch``).  ``after(stage)``
    (if given) is called after the world-1 references, the dry runs (which
    run while the ranks do) and the ranks (``scripts/mesh_host_probe.py``)."""
    import hashlib
    import multiprocessing

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.params import AbstractMesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    models = [(a, d) for a, d in MESH_MODELS if archs is None or a in archs]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products, here and in the ranks

    # --- world 1: the references, computed first and freed -----------------
    refs = {}
    for arch, layers in models:
        t0 = time.perf_counter()
        r = refs[arch] = mesh_world1(arch, layers, dev, smoke)
        log(f"[mesh] {arch} world 1 references in {time.perf_counter() - t0:.1f} s: float32 at "
            f"{mesh_config(arch, 'float32', layers, smoke).n_layers} layers, step ms "
            f"{[round(x, 1) for x in r['ms32']]}, losses {[m['loss'] for m in r['ref32']]}; "
            f"float64 at {MESH_F64_LAYERS} layers, losses {[m['loss'] for m in r['ref64']]}, "
            f"grad norms {[m['grad_norm'] for m in r['ref64']]}")
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    after = after or (lambda stage: None)
    after("world-1 references")

    # --- the ranks, and meanwhile (this process waits on them) the dry
    # run's prediction for one device of the 2 x 2 mesh ---------------------
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, world, f"file://{tmp}/rendezvous", tmp,
                                                     models, smoke))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        predicted = {}
        shape = ShapeConfig("mesh_train", MESH_SEQ, MESH_BATCH, "train")
        for arch, layers in models:
            rec = dryrun.dryrun_cell(mesh_config(arch, "float32", layers, smoke), shape,
                                     AbstractMesh(MESH_SHAPE, MESH_AXES), hw=spec,
                                     device="cuda", roofline=False, n_micro=MESH_MICRO,
                                     ocfg=AdamWConfig(**MESH_ADAMW))
            check(rec["status"] == "ok", f"[mesh] {arch} dry run: {rec}")
            predicted[arch] = rec["memory"]["peak_estimate_bytes"]
        after("dry run")
        for p in procs:
            p.join(timeout=900)
        ranks_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            check(p.exitcode == 0, f"[mesh] rank {r} exited with {p.exitcode}")
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
        restored, routes = {}, {}
        for arch, _ in models:
            tree, step = Checkpointer(f"{tmp}/{arch}_ckpt").restore(refs[arch]["tree64"])
            check(step == MESH_STEPS, f"[mesh] {arch}: the checkpoint's step {step}")
            restored[arch] = tree_leaves(tree)
            routes[arch] = [torch.load(r[arch]["routes"]) if "routes" in r[arch] else []
                            for r in ranks]
    after("ranks")

    # --- gates and what it prints, model by model ---------------------------
    def rel(a, b):
        return abs(a - b) / abs(b)

    log(f"[mesh] on a {MESH_SHAPE} {MESH_AXES} mesh of {world} gloo ranks on cuda:0, "
        f"TRAIN_RULES, {MESH_STEPS} steps of {MESH_BATCH} x {MESH_SEQ} in {MESH_MICRO} "
        f"microbatches, remat, AdamW f32 moments, on {smi_line}; the ranks ran in "
        f"{ranks_s:.1f} s; collective route: all-gather (Shard -> Replicate) by "
        f"{ranks[0]['route']}; reduce-scatter (Partial -> Shard), all-reduce (Partial -> "
        f"Replicate) and all-to-all by the functional collectives")
    for arch, layers in models:
        ref, got = refs[arch], [r[arch] for r in ranks]
        cfg32 = mesh_config(arch, "float32", layers, smoke)
        for r, g in zip(ranks, got):
            tag = f"[mesh] {arch} rank {r['rank']} at {r['coord']}"
            check(not g["placement_mismatches"], f"{tag}: leaves off their logical_spec: "
                  f"{g['placement_mismatches']}")
            for i, (m, w) in enumerate(zip(g["f32_metrics"], ref["ref32"])):
                check(np.isfinite(m["loss"]) and rel(m["loss"], w["loss"]) <= MESH_F32_LOSS_RTOL,
                      f"{tag}: float32 step {i} loss {m['loss']} vs world 1 {w['loss']}")
            for i, (m, w) in enumerate(zip(g["f64_metrics"], ref["ref64"])):
                for key, tol in (("loss", MESH_F64_LOSS_RTOL), ("grad_norm", MESH_F64_RTOL)):
                    check(rel(m[key], w[key]) <= tol,
                          f"{tag}: float64 step {i} {key} {m[key]!r} vs world 1 {w[key]!r}")
        errs = [((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
                for a, b in zip(restored[arch], tree_leaves(ref["tree64"]))]
        leaf_err = max(errs)
        check(leaf_err <= MESH_F64_RTOL,
              f"[mesh] {arch}: float64 leaves after {MESH_STEPS} steps lie {leaf_err:.3e} "
              f"(relative to each leaf's largest) from world 1's, worst "
              f"{leaf_paths(ref['tree64'])[errs.index(leaf_err)]}")
        for r, g in zip(ranks, got):
            for leaf, (pl, digest) in zip(restored[arch], g["local_sha256"]):
                sha = hashlib.sha256(local_shard(leaf, pl, r["coord"], MESH_SHAPE).contiguous()
                                     .numpy().tobytes()).hexdigest()
                check(sha == digest, f"[mesh] {arch} rank {r['rank']}: a leaf restored on "
                      f"world 1 differs from its shard on the mesh ({pl})")
        routes_line = ""
        if ref["routes"]:
            # microbatch i's rows [i b/n, (i+1) b/n) split over "data": a
            # rank's are the slice of its data coordinate
            n_diff = n_all = 0
            for r, rank_routes in zip(ranks, routes[arch]):
                check(len(rank_routes) == len(ref["routes"]),
                      f"[mesh] {arch} rank {r['rank']}: {len(rank_routes)} routed layers' calls "
                      f"against world 1's {len(ref['routes'])}")
                for mine, full in zip(rank_routes, ref["routes"]):
                    rows = mine.shape[0]
                    lo = r["coord"][0] * rows
                    n_diff += int((mine != full[lo:lo + rows]).sum())
                    n_all += mine.numel()
            check(n_diff == 0, f"[mesh] {arch}: {n_diff} of {n_all} float64 top-k indices "
                  f"differ from world 1's")
            routes_line = (f"; float64 top-k indices (first step, {len(ref['routes'])} routed "
                           f"layer calls, forward and remat) differing from world 1's: {n_diff} "
                           f"of {n_all}")
        depth = mesh_config(arch, "float32", None, smoke).n_layers
        log(f"[mesh] {arch} ({cfg32.n_layers} of {depth} layers, d_model "
            f"{cfg32.d_model}, vocab {cfg32.vocab} padded to {cfg32.padded_vocab}, float32); "
            f"per rank in float64 step {MESH_STEPS}: {got[0]['comm_counts']}")
        for r, g in zip(ranks, got):
            ratio = predicted[arch] / (g["peak"] - g["base"])
            log(f"[mesh] {arch} rank {r['rank']} at {r['coord']}: float32 step ms "
                f"{[round(x, 1) for x in g['f32_ms']]}, losses "
                f"{[m['loss'] for m in g['f32_metrics']]} (world 1 "
                f"{[m['loss'] for m in ref['ref32']]}); max_memory_allocated {g['peak']} B "
                f"({g['peak'] / 2**30:.3f} GiB; {g['base']} B before) beside the dry run's "
                f"predicted peak for one device of the 2 x 2 mesh {predicted[arch]} B "
                f"({predicted[arch] / 2**30:.3f} GiB): predicted / measured {ratio:.4f}; "
                f"float64 step ms {[round(x, 1) for x in g['f64_ms']]}, checkpoint save "
                f"{g['save_s']:.1f} s")
        worst = {k: max(rel(m[k], w[k]) for g in got for m, w in zip(g["f64_metrics"],
                                                                     ref["ref64"]))
                 for k in ("loss", "grad_norm")}
        log(f"[mesh] {arch} float64 at {MESH_F64_LAYERS} layers: losses within "
            f"{worst['loss']:.3e} of world 1's (gate {MESH_F64_LOSS_RTOL}), grad norms (float32, "
            f"AdamW's) within {worst['grad_norm']:.3e} (gate {MESH_F64_RTOL}), every leaf after "
            f"{MESH_STEPS} steps within {leaf_err:.3e} of its largest (gate {MESH_F64_RTOL}); "
            f"{got[0]['n_leaves']} parameter leaves on their logical_spec on every rank; the "
            f"ranks' checkpoint restores on world 1 bit for bit their shards "
            f"({len(restored[arch])} leaves); float32 losses within {MESH_F32_LOSS_RTOL} of "
            f"world 1{routes_line}")
    log(f"[mesh] each rank exited 0; phase took {time.perf_counter() - t_phase:.1f} s")


def mesh_child(smi_line: str) -> None:
    """``[mesh]`` in a process spawned for it by :func:`main`."""
    from repro_torch.analysis.roofline import spec_for

    mesh_phase(torch.device("cuda"), spec_for(torch.cuda.get_device_name(0)), smi_line)


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
    from repro_torch.analysis.roofline import spec_for
    from repro_torch.kernels import build, ops, ref

    # the kernels' module (``repro_torch.kernels.hbp_spmv`` is also the name
    # of the ops entry point, which an attribute import would return)
    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    from repro_torch.serving import MatrixRegistry, QoSClass, ServingEngine

    from repro_torch.core import spmm, spmv

    sys.path.insert(0, str(ROOT / "tests"))
    from hub_runs import ZERO_CONFIG, hub_config, hub_coo, signed_zero_coo

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
    spec = spec_for(kind)
    peak_bw, peak_flops = spec.hbm_bw, spec.peak_flops
    log(f"[device] {smi_line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
        f"peaks of the {spec.name} (repro_torch.analysis.roofline): {peak_bw / 1e12} TB/s, "
        f"{peak_flops / 1e12} TFLOP/s f32")

    # --- mesh: the train step on a 2 x 2 mesh of gloo ranks on cuda:0, run
    # first (spawned after the later phases, its ranks moved their gloo
    # traffic 3x slower: 366 s against 145-174 s alone) and in a process of
    # its own: run in this process, it left the host-bound phases after it
    # slower ([lm-train] 755 against 594-651 ms a step run alone,
    # scripts/mesh_host_probe.py).  It needs no kernel: it starts before
    # the build, which runs beside its world-1 references
    import multiprocessing

    child = multiprocessing.get_context("spawn").Process(target=mesh_child, args=(smi_line,))
    child.start()

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s (beside [mesh])")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    child.join(timeout=900)
    if child.is_alive():
        child.kill()
        child.join()
    check(child.exitcode == 0, f"[mesh] its process exited with {child.exitcode}")

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
    widths = (1, 8, 40, 128, 250, 256)  # checked against the plain versions
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
        for k in widths:
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
            # kernel 4 with its run combine (the entry point's launch call)
            exactly(K.hbp_spmm_partials_max(d, X, runs=True),
                    K.hbp_spmm_partials_max_plain(d, X, runs=True),
                    f"{label} hbp_spmm_partials_max runs=True k={k}")
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
        # through the entry points: bucket padding (5 -> 8) and the max
        # monoid on every strategy against numpy
        X5 = torch.randn(d.shape[1], 5, device=dev, generator=g)
        X5[:, 3] = x
        X256 = torch.randn(d.shape[1], 256, device=dev, generator=g)
        for strategy in ("fused", "partials"):
            y_served = ops.hbp_spmv(d, x, strategy=strategy)
            check(torch.equal(ops.hbp_spmm_bucketed(d, X5, strategy=strategy)[:, 3], y_served),
                  f"{label} {strategy}: bucket-padded column != SpMV")
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
            + "; max kernels (and kernel 4 with its run combine) exactly plain at k="
            + ", ".join(map(str, widths)) + "; bitwise SpMV == SpMM column "
              "(fused and partials, k=" + ", ".join(map(str, widths)) + ", bucket 5->8; "
              "partials on the "
              "scalar-column path at k=3, 129 and 128 with x offset by one float); "
              "max at k=256 equal under fused/partials/stable and to numpy on columns "
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
            same_bits(K.hbp_spmm_partials_max(d, X, runs=True), Yf,
                      f"{label} partials max with its run combine k={k}")
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

    # --- zero: IEEE's maximum ranks +0.0 above -0.0 -----------------------
    # x = 0 makes every product -0.0 or +0.0; the probe rows meet the tie in
    # lane order, in tile order and across the two chunks of a split run
    # (tests/hub_runs.py).  Kernels 3-4 (kernel 4 with the run combine), the
    # plain versions and both entry points, compared as bit patterns.
    z_rows, z_cols, z_vals, z_shape, z_want = signed_zero_coo()
    dz = ops.device_tiles(build_tiles(csr_from_coo(COOMatrix(z_rows, z_cols, z_vals, z_shape)),
                                      PartitionConfig(**ZERO_CONFIG)), dev)
    check(dz.n_split_chunks > 0, "the signed-zero probe has no split run")

    def zero_bits(y_hashed):
        # rows with no live entry hold the identity -inf; they come out 0
        y_hashed = y_hashed.masked_fill(torch.isneginf(y_hashed), 0.0)
        return ref.unpermute(y_hashed, dz.perm, z_shape[0]).view(torch.int32)

    for sign in (0.0, -0.0):
        # with x = -0.0 the products flip sign: the all-(-1) row gives +0.0
        want_z = np.zeros_like(z_want) if np.signbit(sign) else z_want
        for k in (1, 4, 8, 128):
            X = torch.full((z_shape[1], k), sign, device=dev)
            want_t = torch.as_tensor(np.repeat(want_z[:, None], k, 1), device=dev).view(torch.int32)
            Yf, P = K.hbp_spmm_fused_max(dz, X), K.hbp_spmm_partials_max(dz, X)
            check(torch.equal(Yf.view(torch.int32), K.hbp_spmm_fused_max_plain(dz, X).view(torch.int32))
                  and torch.equal(P.view(torch.int32),
                                  K.hbp_spmm_partials_max_plain(dz, X).view(torch.int32)),
                  f"zero x={sign} k={k}: kernels 3-4 differ from their plain versions in bits")
            check(torch.equal(zero_bits(Yf), want_t), f"zero x={sign} k={k}: kernel 3's sign of zero")
            combined = ref.segment_max_sorted(P, dz.rowgroup, dz.n_rowgroups, dz.rg_lengths)
            check(torch.equal(zero_bits(combined), want_t),
                  f"zero x={sign} k={k}: kernel 4 + combine's sign of zero")
            runs = K.hbp_spmm_partials_max(dz, X, runs=True)
            check(torch.equal(zero_bits(runs), want_t),
                  f"zero x={sign} k={k}: kernel 4 + its combine kernel's sign of zero")
            for strategy in ("fused", "partials", "stable"):
                got = ops.hbp_spmm(dz, X, strategy=strategy, combine="max").view(torch.int32)
                check(torch.equal(got, want_t), f"zero x={sign} k={k}: {strategy} entry point")
    log("[zero] kernels 3-4, their plain versions, the run combine (plain and kernel 4's "
        "combine kernel) and the fused, partials and "
        "stable entry points give +0.0 above -0.0 (lane order, tile order, split-run fold) and "
        "-0.0 for a row of -0.0 products, at x = +0/-0 and k = 1, 4, 8, 128, as bit patterns")

    # --- spmv: the front door on CSR (cuSPARSE) and on HBP tiles ----------
    reset_counts()
    kron64 = Float64Csr(kron, dev)
    x = torch.randn(kron.shape[1], device=dev, generator=g)
    X8 = torch.randn(kron.shape[1], 8, device=dev, generator=g)
    # the default backend: both containers run on the card
    for label, A_in in (("csr", kron), ("tiles", kron_tiles)):
        y = spmv(A_in, x)
        check(y.shape == (kron.shape[0],) and y.device.type == "cuda", f"[spmv] {label}: {y.shape}")
        kron64.check(y[:, None], x[:, None], f"spmv {label}")
        col = spmv(A_in, x[:, None])
        check(col.shape == (kron.shape[0], 1), f"[spmv] {label}: [n, 1] became {tuple(col.shape)}")
        kron64.check(col, x[:, None], f"spmv {label} [n, 1]")
        Y = spmm(A_in, X8)
        check(Y.shape == (kron.shape[0], 8), f"[spmm] {label}: {tuple(Y.shape)}")
        kron64.check(Y, X8, f"spmm {label}")
    counts = read_counts(("hbp_spmv_fused", "hbp_spmm_fused"))
    check(all(n > 0 for n in counts.values()), f"[spmv] the tiles took no kernel: {counts}")
    log(f"[spmv] spmv / spmm on m4_kron16 as CSRMatrix (torch sparse CSR, cuSPARSE) and as "
        f"HBPTiles (fused kernels: {counts}) within 1e-5 * (|A| |x|) of float64; [n, 1] kept")
    del kron64

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

        # --- telemetry and the distributed SpMV on m4_kron16 ----------------
        telemetry_launches = telemetry_phase(kron, spec, reset_counts, read_counts, cache)
        distributed_launches = {"hbp_spmv_partials": distributed_phase(kron, kron_cfg, dev)}

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
        graph_regs = {}  # kept for the training phase, which serves A_hat again
        for strategy in ("fused", "partials"):
            reg = graph_regs[strategy] = MatrixRegistry(
                device="cuda", cache_dir=cache, search=False, strategy=strategy)
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

        # --- train: GCN and GraphSAGE training at full width ---------------
        train_phase(graph_regs, A, dev, g, wrappers, reset_counts, read_counts)
        del graph_regs

        # --- solvers: CG, PCG, BiCGSTAB, Chebyshev, PageRank, power ------
        solver_launches = solvers_phase(kron, A, dev, g, reset_counts, read_counts, cache)
        for name, n in solver_launches.items():
            check(n > 0, f"{name} was never launched on the solvers path")

    # --- lm: OLMo-1B served on the card, its FFNs pruned through kernels 1-2 --
    lm_launches, lm_memory = lm_phase(dev, spec, smi_line, reset_counts, read_counts)

    # --- lm-train: OLMo-1B trained on the card (no HBP kernel on this path) --
    train_memory = lm_train_phase(dev, smi_line)

    # --- dryrun: the abstract trace held to the two measured peaks ---------
    dryrun_phase(spec, smi_line, lm_memory, train_memory)

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
         for name in ("hbp_spmm_fused", "hbp_spmm_partials", "hbp_spmm_fused_max",
                      "hbp_spmm_partials_max")] + [
        ("m4_kron16", "hbp_spmm_fused", 40),  # the GCN cells' output width
        ("m4_kron16", "hbp_spmm_fused", 250)] + [  # a GAT head's width (float2 columns)
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
        for key, counts in (("solver_launches", solver_launches),
                            ("telemetry_launches", telemetry_launches),
                            ("distributed_launches", distributed_launches),
                            ("lm_launches", lm_launches)):
            if name in counts:
                row[key] = counts[name]
        if "fused" in name:
            # the split runs' chunk partials, written by the chains and
            # read back by the fold (beside bound_ms, not in it)
            buf = 2 * d.chunk_buffer_nbytes(k)
            row["chunk_buffer_bytes"] = buf
            row["chunk_buffer_ms"] = buf / peak_bw * 1e3
        if name == "hbp_spmm_partials_max":
            # the entry point's launch call: kernel 4 and its run combine
            # on the card; beside it the plain combine over the partials
            # (segment_reduce and the +0.0 pass), which it replaces
            contrib = kern(d, arg)
            row["runs_ms"] = timed_ms(lambda: kern(d, arg, runs=True), 10)
            row["plain_combine_ms"] = timed_ms(lambda: ref.segment_max_sorted(
                contrib, d.rowgroup, d.n_rowgroups, d.rg_lengths), 10)
        elif "partials" in name:
            # the combine's time: it reads the partials back
            contrib = kern(d, arg)
            view = contrib[..., None] if k == 1 else contrib
            row["combine_ms"] = timed_ms(lambda: ref.segment_sum_sorted(
                view, d.rowgroup, d.n_rowgroups, d.rg_lengths), 10)
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
    # the argmax kernel (it replaces no TPU kernel) against kernel 3 on the
    # same tiles and x, at the widths of the max rows
    for k in (8, 128, 256):
        X = torch.randn(kron.shape[1], k, device=dev, generator=g)
        row = argmax_times_row(K, dt, X, peak_bw)
        check(row["exact"], f"argmax kernel at k={k}: not bitwise its plain version")
        row.update(matrix="m4_kron16", card=smi_line)
        log("[times] " + json.dumps(row))
    # GAT's SDDMM kernel (it replaces no TPU kernel) on A + I of the graph
    # phase's A, at the heads and widths of the gat.train.kron16 cell
    # and its edge softmax kernels, forward and backward, at 3 heads
    looped = add_self_loops(A)
    for row in (sddmm_times_rows(looped, dev, g, smi_line)
                + softmax_times_rows(looped, dev, g, smi_line)):
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
