"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 50 \
        --smoke --batch 8 --seq 128 [--device cpu]

``--smoke`` runs the reduced same-family config; without it the full
config is built.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import math

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model, tree_map
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    sizes = []
    tree_map(lambda d: sizes.append(math.prod(d.shape)), model.defs)
    print(f"arch={cfg.name} params={sum(sizes)/1e6:.1f}M")

    trainer = Trainer(
        model,
        AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1), decay_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        TrainerConfig(
            steps=args.steps,
            log_every=max(args.steps // 10, 1),
            checkpoint_every=max(args.steps // 2, 1),
            checkpoint_dir=args.ckpt,
            n_microbatch=args.microbatch,
        ),
        device=dev,
    )
    trainer.run()


if __name__ == "__main__":
    main()
