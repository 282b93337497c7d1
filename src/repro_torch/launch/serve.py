"""Serving launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \
        --requests 8 --max-new 16 [--sparsity 0.9] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  ``--sparsity``
additionally builds HBP ``SparseLinear`` versions of each layer group's
first FFN down-projection (the paper's technique as a serving feature) and
reports their density; decode itself runs the dense model, as the JAX
package's launcher does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import Engine, EngineConfig, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)

    if args.sparsity > 0:
        from repro_torch.core.sparse_linear import SparseLinear

        dens = []
        for sub in params["dec"]["stack"].values():
            if "ffn" not in sub:
                continue
            w = sub["ffn"]["w2"][0].float().cpu().numpy()
            dens.append(SparseLinear.from_dense(w.T, sparsity=args.sparsity, device=dev).density())
        print(f"HBP sparse FFNs: target sparsity {args.sparsity}, density {np.mean(dens):.3f}")

    engine = Engine(model, params, EngineConfig(batch=args.batch, max_len=256), device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                max_new=args.max_new)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    engine.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the host CPU"
    total = sum(r.max_new for r in reqs)
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {where})")
    for i, r in enumerate(reqs[:3]):
        print(f"req{i}: {r.out[:10].tolist()}")


if __name__ == "__main__":
    main()
