"""Batched serving engine: prefill + greedy/sampled decode.

The JAX package's engine, batch for batch: a fixed-size decode batch, one
prefill step over the left-padded prompts and one decode step per new
token, the cache preallocated once per batch and written in place (the
JAX engine donates it to its decode step for the same effect).  Requests
are served in fixed groups of ``EngineConfig.batch``.

Prompts are left-padded with token 0 and attend to the padding: there is
no pad mask, as in the JAX package.  Each step's tokens come to the host
once, as one list.  Sampling (``temperature > 0``) draws from a
``torch.Generator`` seeded from ``EngineConfig.seed``; it cannot give
``jax.random.categorical``'s tokens.  As in the JAX package the first
token of every request is the prefill's argmax.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import tree_map

from .steps import make_decode_step, make_prefill_step

__all__ = ["EngineConfig", "Engine", "Request"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # int32[prompt_len]
    max_new: int = 32
    out: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch: int = 4
    max_len: int = 512
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


class Engine:
    """Serves requests on ``device`` (default: the card; the parameters are
    moved there if they are elsewhere)."""

    def __init__(self, model: Model, params, cfg: EngineConfig, *, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests in fixed-size batches."""
        cfg = self.cfg
        for i in range(0, len(requests), cfg.batch):
            self._run_batch(requests[i : i + cfg.batch])
        return requests

    def _run_batch(self, reqs: List[Request]) -> None:
        cfg = self.cfg
        B = cfg.batch
        dev = self.device
        plen = max(int(r.prompt.size) for r in reqs)
        max_new = max(r.max_new for r in reqs)
        total = plen + max_new
        if total > cfg.max_len:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds max_len {cfg.max_len}")

        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - r.prompt.size :] = r.prompt  # left-pad
        cache = self.model.init_cache(B, cfg.max_len, cross_len=plen, device=dev)
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
        if self.model.cfg.is_encdec:
            batch["frames"] = torch.zeros((B, plen, self.model.cfg.d_model), device=dev)
        cache, last_logits = self._prefill(self.params, batch, cache)

        outs = [list() for _ in reqs]
        cur = torch.argmax(last_logits, dim=-1)[:, None]
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        for step in range(max_new):
            host = cur[:, 0].tolist()  # one read of the step's tokens
            for i in range(len(reqs)):
                outs[i].append(host[i])
            cache, nxt, logits = self._decode(self.params, cache, cur.long(), plen + step)
            if cfg.temperature > 0:
                probs = torch.softmax(logits / cfg.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)
            cur = nxt
        for i, r in enumerate(reqs):
            r.out = np.asarray(outs[i][: r.max_new], np.int32)
