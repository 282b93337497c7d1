"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The JAX package's dispatch, step for step: dispatch is a *permutation*
(gathers along the sequence dim), not a one-hot einsum.  Per sequence:

1. route: top-k experts per token, f32 router, Switch aux loss;
2. sort (token, slot) pairs by expert id (stable per-sequence argsort);
3. gather expert buffers: slot (e, c) of the ``[B, E, C, D]`` buffer reads
   sorted position ``starts[e] + c`` (beyond-count slots read a zero pad
   row);
4. expert products;
5. combine: the inverse gathers, then fold the K slots per token.

Capacity is per sequence: ``C = min(S, max(4, int(S·K/E · capacity_factor)))``;
overflow slots are dropped (their tokens pass through on the residual
only).  Decode (S = 1) routes exactly.  DeepSeek-style shared experts are
dense FFNs added to the routed output.

Ties in the router go to the lower expert index, as ``jax.lax.top_k``
puts them: the top k are the first k of a stable descending sort
(``torch.topk`` promises no order on ties).  Every index map is
injective (pad-extended), so each gather goes through :func:`_permute`,
whose backward is itself a gather through the inverse map, as the JAX
package's custom VJP is: autograd's own backward of a gather would be a
scatter-add, which also turns a ``-0.0`` gradient into ``+0.0``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import _activate, mlp_apply, mlp_defs
from .params import ParamDef

__all__ = ["moe_defs", "moe_apply"]


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    gated = cfg.act != "relu2"
    defs: Dict = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "w1": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "w2": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }
    if gated:
        defs["wg"] = ParamDef((e, d, f), ("experts", "embed", "mlp"))
    for s in range(cfg.moe_shared):
        defs[f"shared_{s}"] = mlp_defs(cfg)
    return defs


def _take_padded(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, i] = x[b, idx[b, i]]``; index ``x.shape[1]`` reads a zero
    pad row."""
    B, N, D = x.shape
    padded = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    return torch.gather(padded, 1, idx[..., None].expand(-1, -1, D))


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        return _take_padded(x, fwd_idx)

    @staticmethod
    def backward(ctx, g):
        (bwd_idx,) = ctx.saved_tensors
        return _take_padded(g, bwd_idx), None, None


def _permute(x: torch.Tensor, fwd_idx: torch.Tensor, bwd_idx: torch.Tensor) -> torch.Tensor:
    """Injective padded permutation ``out[b, i] = x[b, fwd_idx[b, i]]``
    (index ``x.shape[1]`` reads the zero pad row).  ``bwd_idx`` is the
    inverse map (index ``out.shape[1]`` for a row nothing reads), so the
    gradient is the gather ``dx[b, j] = g[b, bwd_idx[b, j]]``."""
    return _Permute.apply(x, fwd_idx, bwd_idx)


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D], aux_loss scalar)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = S * K  # routing slots per sequence
    dev = x.device

    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :K], idx[..., :K]  # [B,S,K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # Switch-style load-balancing loss (fraction routed vs mean prob)
    me = probs.mean(dim=(0, 1))  # [E]
    ce = F.one_hot(idx.reshape(B, T), E).float().sum(dim=(0, 1)) / (B * T)
    aux = E * torch.sum(me * ce)

    if S == 1:
        capacity = 1  # decode: exact routing (top-k experts are distinct)
    else:
        capacity = min(S, max(4, int(S * K / E * cfg.capacity_factor)))
    C = capacity

    # ---- sort slots by expert (per sequence; batch dim stays positional)
    e_flat = idx.reshape(B, T)
    order = torch.argsort(e_flat, dim=-1, stable=True)  # [B, T]
    inv_order = torch.argsort(order, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, -1, order)
    counts = F.one_hot(e_flat, E).sum(dim=1)  # [B,E]
    starts = torch.cumsum(counts, dim=-1) - counts  # exclusive per-expert start
    rank = torch.arange(T, device=dev)[None, :] - torch.gather(starts, -1, e_sorted)
    keep = rank < C  # beyond-capacity slots are dropped

    # ---- dispatch: token -> K slots -> sorted slots -> expert buffers
    x_slots = torch.repeat_interleave(x, K, dim=1)  # [B, T, D]
    xs = _permute(x_slots, order, inv_order)  # [B, T, D]
    arange_c = torch.arange(C, device=dev)
    src = starts[:, :, None] + arange_c[None, None, :]  # [B, E, C]
    valid = arange_c[None, None, :] < counts[:, :, None]
    src = torch.where(valid, src, T).reshape(B, E * C)
    slot_dest = torch.where(keep, e_sorted * C + rank, E * C)  # inverse map
    expert_in = _permute(xs, src, slot_dest).reshape(B, E, C, D)

    if cfg.act != "relu2":
        h = _activate(
            torch.einsum("becd,edf->becf", expert_in, p["wg"]), cfg.act
        ) * torch.einsum("becd,edf->becf", expert_in, p["w1"])
    else:
        h = _activate(torch.einsum("becd,edf->becf", expert_in, p["w1"]), cfg.act)
    eout = torch.einsum("becf,efd->becd", h, p["w2"]).reshape(B, E * C, D)

    # ---- combine: sorted slot <- expert buffer slot (dropped -> 0)
    contrib = _permute(eout, slot_dest, src)  # [B, T, D]
    gate_sorted = torch.gather(gates.reshape(B, T), -1, order)
    contrib = contrib * gate_sorted[..., None].to(contrib.dtype)
    # slot <- sorted slot, then fold the K slots per token
    contrib = _permute(contrib, inv_order, order)
    out = contrib.reshape(B, S, K, D).sum(dim=2)

    for s in range(cfg.moe_shared):
        out = out + mlp_apply(p[f"shared_{s}"], x, cfg)
    return out.to(x.dtype), aux
