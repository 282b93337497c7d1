"""Deterministic synthetic token pipeline.

The JAX package's ``repro.data.pipeline``, its numpy half copied: batches
come from a counter-based RNG keyed by ``(seed, step, lo, hi)``, so the
stream is

* **restart-exact** — resuming from a checkpoint at step k regenerates
  exactly the batches an interrupted run would have seen;
* **host-shardable** — a process may make only rows ``[lo, hi)`` of the
  global batch;
* **structured** — a Zipf unigram marginal plus a first-order mixing
  process, so cross-entropy has learnable structure (the loss falls).

Both packages draw the same tokens for the same ``(seed, step, lo, hi)``.
:func:`make_global_batch` puts a step's batch on the card (or on
``device``) as int64 token ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "make_global_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    # markov mixing: p(next ~ f(prev)) vs fresh zipf draw
    mix: float = 0.7


class SyntheticLM:
    """Deterministic, seekable synthetic LM token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def batch_at(self, step: int, *, lo: int = 0, hi: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Global batch rows [lo, hi) for ``step`` (host slice support)."""
        cfg = self.cfg
        hi = cfg.global_batch if hi is None else hi
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, lo, hi]))
        n = hi - lo
        fresh = rng.choice(cfg.vocab, size=(n, cfg.seq_len), p=self._probs)
        toks = fresh.copy()
        # first-order structure: next token correlated with prev
        keep = rng.random((n, cfg.seq_len)) < cfg.mix
        shifted = (toks[:, :-1] * 31 + 7) % cfg.vocab
        toks[:, 1:] = np.where(keep[:, 1:], shifted, fresh[:, 1:])
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_global_batch(stream: SyntheticLM, step: int, device=None) -> Dict[str, torch.Tensor]:
    """Step ``step``'s global batch on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in stream.batch_at(step).items()}
