#!/usr/bin/env python3
"""How far a float32 train step of OLMo-1B's width lies from float64, by depth.

    python3 scripts/lm_train_chaos.py [--layers 1 2 4]

On one CUDA card, for each depth: one train step (global batch 8 x 1024 of
the synthetic stream, two microbatches, remat, the launcher's AdamW at 8
steps) from the same bf16 random weights, in float32 (TF32 off) and in
float64, and per parameter leaf the first moment's relative L2 error, the
update's, the share of update signs that differ and the largest parameter
difference (``chip_smoke.step_stats``), beside both losses and grad norms.
This is why ``chip_smoke.py``'s ``[lm-train]`` holds float32 to float64 at
2 layers: the random weights saturate attention and the error grows with
depth.
"""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
    from repro_torch.models import build_model, tree_map
    from repro_torch.models.params import dtype_of
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    cfg = get_config(cs.LM_ARCH)
    steps = cs.LM_TRAIN_STEPS
    opt = adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=cs.LM_TRAIN_SEQ, global_batch=cs.LM_TRAIN_BATCH)
    batch = make_global_batch(SyntheticLM(data), 0, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    for layers in args.layers:
        c = dataclasses.replace(cfg, n_layers=layers)
        base = build_model(c).init(torch.Generator().manual_seed(1), device=dev)
        out = {}
        for dtype in ("float32", "float64"):
            cd = dataclasses.replace(c, dtype=dtype)
            params = tree_map(lambda t: t.to(dtype_of(cd)), base)
            state = {"params": params, "opt": adamw.init_opt_state(params, opt)}
            step = make_train_step(build_model(cd), opt, n_microbatch=cs.LM_TRAIN_MICRO,
                                   remat=True)
            out[dtype] = step(state, batch)
        (s32, m32), (s64, m64) = out["float32"], out["float64"]
        cs.log(f"[chaos] {layers} layer(s): loss {float(m32['loss']):.8f} / "
               f"{float(m64['loss']):.8f}, grad norm {float(m32['grad_norm']):.6e} / "
               f"{float(m64['grad_norm']):.6e} (float32 / float64)")
        for name, row in zip(sorted(cs.flat_paths(base)), cs.step_stats(s32, s64, base)):
            cs.log(f"[chaos]   {name}: first moment rel L2 {row['m_rel']:.3e}, update rel L2 "
                   f"{row['update_rel']:.3e}, sign changes {row['flips']:.3e}, max |err| "
                   f"{row['max_err']:.3e}")
        del out, s32, s64, base
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
