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
``device``) as int64 token ids, or on a mesh as a DTensor sharded over the
batch's axes, each rank holding only its own rows of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.params import (
    NamedSharding,
    TRAIN_RULES,
    collective_route,
    logical_spec,
    placements,
)

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


def _sharded(stream: SyntheticLM, step: int, key: str, sharding: NamedSharding) -> DTensor:
    """Entry ``key`` of the global batch as a DTensor with ``sharding``,
    from this rank's rows of it (``jax.make_array_from_process_local_data``).
    Each rank draws the whole batch and keeps its rows: ``batch_at(step,
    lo=, hi=)`` keys a generator of its own by ``(lo, hi)`` (the JAX
    package's per-host slice), whose rows are not the global batch's."""
    mesh, want = sharding.mesh, placements(sharding.spec, sharding.mesh)
    if any(p.is_shard() and p.dim != 0 for p in want):
        raise ValueError(f"a batch is sharded on its batch dim only: {sharding.spec}")
    collective_route(mesh)
    B = stream.cfg.global_batch
    lo, hi = 0, B  # this rank's rows: its coordinate on each axis of dim 0
    for i, p in enumerate(want):
        if p.is_shard():
            n = (hi - lo) // mesh.size(i)
            lo += mesh.get_local_rank(i) * n
            hi = lo + n
    local = torch.from_numpy(stream.batch_at(step)[key][lo:hi]).to(
        mesh.device_type, torch.int64)
    return DTensor.from_local(local, mesh, want, run_check=False)


def make_global_batch(stream: SyntheticLM, step: int, device=None, *, mesh=None,
                      sharding=None) -> Dict[str, torch.Tensor]:
    """Step ``step``'s global batch on ``device`` (default: the card).

    ``sharding`` (a dict of
    :class:`~repro_torch.models.params.NamedSharding` by key) gives each
    entry as a DTensor with its placements, every rank keeping only its
    own rows (for its coordinate on the batch dim's axes; the counterpart
    of ``jax.make_array_from_process_local_data``);
    ``mesh`` alone shards the batch over ``("pod", "data")`` as
    ``TRAIN_RULES`` do.  Either way ``full_tensor()`` is bit for bit the
    call without a mesh."""
    if mesh is not None and sharding is None:
        cfg = stream.cfg
        spec = logical_spec((cfg.global_batch, cfg.seq_len), ("batch", None), TRAIN_RULES, mesh)
        sharding = {"tokens": NamedSharding(mesh, spec)}
    if sharding is not None:
        return {k: _sharded(stream, step, k, s) for k, s in sharding.items()}
    dev = resolve_device(device)
    host = stream.batch_at(step)
    return {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in host.items()}
