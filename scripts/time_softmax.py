#!/usr/bin/env python3
"""Time GAT's edge softmax kernels (``csrc/hbp_softmax.cu``) at other launch
geometries, in turns, on one CUDA card.

    python3 scripts/time_softmax.py [--rounds 3] [--out chiprun_out/softmax_sweep.jsonl]

On ``A + I`` of ``rmat_graph(1 << 16, 79.345703125, seed=4)`` (the
``gat.train.kron16`` cell's graph; symmetric, so one tile set serves A and
Aᵀ) at 3 heads, for each geometry of ``GEOMETRIES`` (a block's threads, and
the row length above which a row is walked by a whole block and not by a
warp; ``None``: every row by a warp) the launches of a layer are timed apart
by CUDA events, each as the mean over launches filling ``WINDOW_MS``: the
forward (``hbp_edge_softmax``), the backward by rows, the column sums, and
once the rewrite of α into the tile copies (``hbp_rewrite``, which takes no
geometry).  The geometries run in turns, forward then backward order in
alternate rounds, so a drift of the card's clock falls on all of them.
Every case prints one JSON object (with the card's name and power limit)
and a SHA-256 of the outputs: a geometry changes the order of a long row's
sums, and so may change the last bits.
"""
import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

WINDOW_MS = 100.0
# (threads a block, long-row length): the shipped geometry first
GEOMETRIES = [(512, 512), (256, 256), (128, 128), (1024, 1024), (256, 1024), (1024, 256),
              (256, None)]


def timed_ms(fn) -> float:
    """Mean CUDA-event time of ``fn`` over launches filling ``WINDOW_MS``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(5, int(WINDOW_MS / max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/softmax_sweep.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.core import build_tiles, tuned_partition_config
    from repro_torch.graph import add_self_loops, rmat_graph
    from repro_torch.kernels import autodiff

    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    adj = add_self_loops(rmat_graph(1 << 16, 79.345703125, seed=4))
    tiles = build_tiles(adj, tuned_partition_config(adj))
    maps = autodiff.attention_maps(adj, tiles, tiles, dev)
    heads = 3
    g = torch.Generator(device=dev).manual_seed(0)
    s_src, s_dst = torch.randn((2, adj.shape[0], heads), device=dev, generator=g).unbind(0)
    d_alpha = torch.randn((adj.nnz, heads), device=dev, generator=g)
    walks = {}
    for _, long_row in GEOMETRIES:
        K.SOFTMAX_LONG_ROW = long_row if long_row is not None else adj.nnz
        # symmetric: A's rows and Aᵀ's have one structure
        walks[long_row] = K.row_walk(maps.indptr)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for r in range(args.rounds):
            alpha = K.hbp_edge_softmax(maps.indptr, maps.cols, walks[512], s_src, s_dst)
            row = {"round": r, "slots": tiles.data.size,
                   "rewrite_ms": timed_ms(lambda: K.hbp_rewrite(maps.entry, alpha)),
                   "rewrite_T_ms": timed_ms(lambda: K.hbp_rewrite(maps.entry_T, alpha)),
                   "card": card}
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
            for threads, long_row in GEOMETRIES if r % 2 == 0 else GEOMETRIES[::-1]:
                K.SOFTMAX_THREADS = threads
                walk = walks[long_row]

                def forward():
                    return K.hbp_edge_softmax(maps.indptr, maps.cols, walk, s_src, s_dst)

                alpha = forward()

                def rows():
                    return K.hbp_edge_softmax_backward(maps.indptr, maps.cols, walk, s_src, s_dst,
                                                       alpha, d_alpha)

                de = rows()[0]

                def columns():
                    return K.hbp_edge_softmax_columns(maps.indptr_T, maps.perm_T, walk, de)

                row = {"round": r, "threads": threads, "long_row": long_row,
                       "n_long": walk.n_long, "forward_ms": timed_ms(forward),
                       "rows_ms": timed_ms(rows), "columns_ms": timed_ms(columns),
                       "sha": digest([forward(), *rows(), columns()]), "card": card}
                print(json.dumps(row), flush=True)
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
