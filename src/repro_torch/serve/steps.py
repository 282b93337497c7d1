"""Serving step factories: prefill and decode.

* ``prefill_step(params, batch, cache) -> (cache, last_logits)`` — runs the
  prompt through the model, filling the KV/state cache;
* ``decode_step(params, cache, tokens, pos) -> (cache, next_token,
  logits)`` — one token against the cache.  Greedy argmax keeps the step
  deterministic (``torch.argmax`` returns the first maximum, as
  ``jnp.argmax`` does); the engine samples if asked.

Both write the cache in place and return it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.model import Model

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor], cache):
        logits, cache, _ = model.forward(params, batch, cache=cache, pos0=0)
        return cache, logits[:, -1].float()

    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor, pos: int):
        """tokens: [B, 1] current token; pos: position index."""
        logits, cache, _ = model.forward(params, {"tokens": tokens}, cache=cache, pos0=pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return cache, nxt[:, None], logits[:, -1]

    return decode_step
