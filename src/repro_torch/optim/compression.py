"""Top-k gradient compression with error feedback.

The JAX package's ``repro.optim.compression``: top-k sparsification with
local error feedback (Stich et al.; Lin et al., "Deep Gradient
Compression") sends ``1/ratio`` fewer gradient bytes over a slow link,
and the coordinates it drops are remembered in a residual and added back
the next step.

Usage (wraps any gradient tree before the optimizer):

    comp = TopKCompressor(ratio=0.01)
    state = comp.init(params)
    grads, state = comp.round_trip(grads, state)   # compress + decompress

``round_trip`` returns the decompressed gradients, so a train step stays
unaware of the wire format; ``compress``/``decompress`` are that format
(f32 values and int32 flat indices).  The k largest ``|g|`` come from
``torch.topk``, which may order ties otherwise than ``jax.lax.top_k``;
on inputs without ties both keep the same coordinates.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .adamw import tree_flatten, tree_leaves

__all__ = ["TopKCompressor"]


class TopKCompressor:
    def __init__(self, ratio: float = 0.01, min_k: int = 16):
        if not 0 < ratio <= 1:
            raise ValueError(ratio)
        self.ratio = ratio
        self.min_k = min_k

    def init(self, params) -> Dict:
        """Error-feedback residual, one per parameter leaf."""
        leaves, rebuild = tree_flatten(params)
        return rebuild([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                        for p in leaves])

    def _k(self, n: int) -> int:
        return max(self.min_k, int(n * self.ratio))

    def compress(self, g: torch.Tensor, residual: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (values, flat indices, new residual) for one leaf."""
        acc = g.to(torch.float32) + residual
        flat = acc.reshape(-1)
        k = self._k(flat.numel())
        if k >= flat.numel():
            idx = torch.arange(flat.numel(), dtype=torch.int32, device=flat.device)
            return flat, idx, torch.zeros_like(residual)
        _, idx = torch.topk(flat.abs(), k)
        sel = flat[idx]
        new_res = flat.clone()
        new_res[idx] = 0.0
        return sel, idx.to(torch.int32), new_res.reshape(residual.shape)

    def decompress(self, vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
        out = torch.zeros(math.prod(shape), dtype=torch.float32, device=vals.device)
        out[idx.long()] = vals
        return out.reshape(shape)

    def round_trip(self, grads, state):
        """Compress + decompress every leaf, carrying error feedback."""
        flat_g, rebuild = tree_flatten(grads)
        flat_r = tree_leaves(state)
        out_g, out_r = [], []
        for g, r in zip(flat_g, flat_r):
            vals, idx, new_r = self.compress(g, r)
            out_g.append(self.decompress(vals, idx, g.shape).to(g.dtype))
            out_r.append(new_r)
        return rebuild(out_g), rebuild(out_r)

    def wire_bytes(self, grads) -> Tuple[int, int]:
        """(uncompressed bf16 bytes, compressed val+idx bytes) per step."""
        leaves = tree_leaves(grads)
        full = sum(2 * g.numel() for g in leaves)
        comp = sum((4 + 4) * self._k(g.numel()) for g in leaves)
        return full, comp
