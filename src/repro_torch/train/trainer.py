"""Training loop with restart.

The JAX package's ``repro.train.trainer`` on the card:

* deterministic data — batch k is a pure function of (seed, k), so a
  restart replays the exact stream (:mod:`repro_torch.data.pipeline`);
* periodic async checkpoints and a restore of the latest one on start
  (:mod:`repro_torch.checkpoint`), in the JAX package's layout;
* a JSON row per log step (``step, loss, grad_norm, lr, wall_s``), kept in
  ``history`` and printed.

The host waits for the card only at log steps (reading the metrics) and
at save steps (the host copy), as the JAX package's jitted loop does.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_global_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    n_microbatch: int = 1
    remat: bool = False
    seed: int = 0


class Trainer:
    def __init__(
        self,
        model: Model,
        opt_cfg: AdamWConfig,
        data_cfg: DataConfig,
        cfg: TrainerConfig,
        *,
        batch_fn: Optional[Callable[[int], Dict]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.stream = SyntheticLM(data_cfg)
        self.batch_fn = batch_fn
        self.step_fn = make_train_step(
            model, opt_cfg, n_microbatch=cfg.n_microbatch, remat=cfg.remat)
        self.ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        self.history: list = []

    def _batch(self, step: int) -> Dict:
        if self.batch_fn is not None:
            return self.batch_fn(step)
        return make_global_batch(self.stream, step, self.device)

    def run(self, state=None) -> Dict:
        """Train; resumes from the latest checkpoint if one exists."""
        start = 0
        if state is None:
            state = init_train_state(self.model, torch.Generator().manual_seed(self.cfg.seed),
                                     self.opt_cfg, device=self.device)
            if self.ckpt and self.ckpt.latest_step() is not None:
                state, start = self.ckpt.restore(state)
                start += 1
        t0 = time.time()
        for step in range(start, self.cfg.steps):
            state, metrics = self.step_fn(state, self._batch(step))
            if step % self.cfg.log_every == 0 or step == self.cfg.steps - 1:
                row = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "wall_s": round(time.time() - t0, 2),
                }
                self.history.append(row)
                print(json.dumps(row))
            if self.ckpt and step and step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, state)
        if self.ckpt:
            self.ckpt.save(self.cfg.steps - 1, state, blocking=True)
        return state
