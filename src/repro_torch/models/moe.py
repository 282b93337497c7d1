"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The JAX package's dispatch, step for step: dispatch is a *permutation*
(gathers along the sequence dim), not a one-hot einsum.  Per sequence:

1. route: top-k experts per token, f32 router (f64 in a float64 model),
   Switch aux loss;
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

On a mesh (a DTensor ``x`` inside a sharding context) the layer runs on
each rank's local tensors with expert parallelism (:func:`_moe_mesh`).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig

from .layers import _activate, mlp_apply, mlp_defs, wide
from .params import (
    ParamDef,
    from_parts,
    get_sharding_ctx,
    local_view,
    logical_spec,
    placements,
    shard,
)

__all__ = ["moe_defs", "moe_apply", "record_routes"]


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


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """(probs [B,S,E], gates [B,S,K] renormalised, idx [B,S,K]); float32
    (float64 in a float64 model, whose aux loss and routes then keep
    float64's rounding)."""
    K = cfg.moe_top_k
    logits = wide(torch.einsum("bsd,de->bse", x, router))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :K], idx[..., :K]  # [B,S,K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _capacity(S: int, cfg: ModelConfig) -> int:
    """Slots per expert per sequence; decode (S = 1) routes exactly (the
    top-k experts are distinct)."""
    if S == 1:
        return 1
    return min(S, max(4, int(S * cfg.moe_top_k / cfg.moe_experts * cfg.capacity_factor)))


def _routed(p: Dict, x: torch.Tensor, gates, idx, cfg: ModelConfig, lo: int, hi: int):
    """The routed output [B,S,D] of experts ``[lo, hi)`` (``p``'s expert
    leaves hold those only): each sequence's slots sorted by expert, the
    expert buffers gathered, the products, and the inverse gathers; the
    slots of other experts add 0."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = S * K  # routing slots per sequence
    dev = x.device
    C = _capacity(S, cfg)

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
    if (lo, hi) != (0, E):
        expert_in = expert_in[:, lo:hi]  # this rank's shard of the buffer

    if cfg.act != "relu2":
        h = _activate(
            torch.einsum("becd,edf->becf", expert_in, p["wg"]), cfg.act
        ) * torch.einsum("becd,edf->becf", expert_in, p["w1"])
    else:
        h = _activate(torch.einsum("becd,edf->becf", expert_in, p["w1"]), cfg.act)
    eout = torch.einsum("becf,efd->becd", h, p["w2"])
    if (lo, hi) != (0, E):  # other experts' buffer slots: 0
        eout = torch.cat([eout.new_zeros(B, lo, C, D), eout, eout.new_zeros(B, E - hi, C, D)], 1)
    eout = eout.reshape(B, E * C, D)

    # ---- combine: sorted slot <- expert buffer slot (dropped -> 0)
    contrib = _permute(eout, slot_dest, src)  # [B, T, D]
    gate_sorted = torch.gather(gates.reshape(B, T), -1, order)
    contrib = contrib * gate_sorted[..., None].to(contrib.dtype)
    # slot <- sorted slot, then fold the K slots per token
    contrib = _permute(contrib, inv_order, order)
    return contrib.reshape(B, S, K, D).sum(dim=2)


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D], aux_loss scalar)."""
    if isinstance(x, DTensor):
        return _moe_mesh(p, x, cfg)
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    probs, gates, idx = _route(x, p["router"], cfg)
    _record(idx)

    # Switch-style load-balancing loss (fraction routed vs mean prob)
    me = probs.mean(dim=(0, 1))  # [E]
    ce = F.one_hot(idx.reshape(B, S * K), E).to(probs.dtype).sum(dim=(0, 1)) / (B * S * K)
    aux = E * torch.sum(me * ce)

    out = _routed(p, x, gates, idx, cfg, 0, E)
    for s in range(cfg.moe_shared):
        out = out + mlp_apply(p[f"shared_{s}"], x, cfg)
    return out.to(x.dtype), aux


_EXPERT_LEAVES = ("w1", "w2", "wg")


def _moe_mesh(p: Dict, x: DTensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` of a DTensor ``x`` on the active mesh.

    The expert buffer is laid out as the JAX package constrains it,
    ``("batch", "act_experts", None, None)``: each rank routes its own
    batch rows (routing is per sequence, the sequence whole) over every
    expert with the whole router, as one device does, so the same slots
    drop, and runs the products of its own experts, those the expert
    leaves' ``experts`` dim puts on it.  Its slots routed to another
    rank's experts add 0, and the ``[rows, S, D]`` outputs are summed over
    the experts' mesh dims.  The aux loss is a product of two means over
    the global batch: ``me`` and ``ce`` are summed over the batch's ranks
    before the product (a mean of the ranks' aux would be another number),
    each rank taking the terms of its own experts."""
    ctx = get_sharding_ctx()
    if ctx is None:
        raise ValueError("moe_apply of a DTensor runs inside a sharding_ctx")
    mesh, rules = ctx
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    xr = shard(x, "batch", None, None)  # the rows over the batch's axes, each sequence whole
    buf = placements(logical_spec((B, E, _capacity(S, cfg), D),
                                  ("batch", "act_experts", None, None), rules, mesh), mesh)
    batch = [i for i, pl in enumerate(buf) if pl.is_shard(0)]
    ep = [i for i, pl in enumerate(buf) if pl.is_shard(1)]
    if tuple(xr.placements) != tuple(Shard(0) if i in batch else Replicate()
                                     for i in range(mesh.ndim)):
        raise ValueError(f"moe_apply: rows placed as {xr.placements}, the expert buffer as "
                         f"{buf}")
    for name in _EXPERT_LEAVES:
        if name in p and tuple(i for i, pl in enumerate(p[name].placements)
                               if pl.is_shard(0)) != tuple(ep):
            raise ValueError(f"moe_apply: expert leaf {name} placed as {p[name].placements}, "
                             f"the expert buffer's experts over mesh dims {ep}; run the "
                             f"parameters on their logical_spec")
    if len(ep) > 1:
        raise ValueError(f"moe_apply: experts over {len(ep)} mesh dims; one is supported")
    lo, hi = 0, E
    if ep:
        n = mesh.size(ep[0])
        lo = mesh.get_local_rank(ep[0]) * (E // n)
        hi = lo + E // n

    def role(i, own, summed):
        return own if i in batch else summed if i in ep else Replicate()

    dims = range(mesh.ndim)
    x_l = local_view(xr, xr.placements, [role(i, Shard(0), Partial()) for i in dims])
    part = [Partial() if (i in batch or i in ep) else Replicate() for i in dims]
    router = local_view(p["router"], [Replicate()] * mesh.ndim, part)
    experts = {name: local_view(p[name], [role(i, Replicate(), Shard(0)) for i in dims],
                                [role(i, Partial(), Shard(0)) for i in dims])
               for name in _EXPERT_LEAVES if name in p}

    probs, gates, idx = _route(x_l, router, cfg)
    _record(idx)
    out_l = _routed(experts, x_l, gates, idx, cfg, lo, hi)
    out = from_parts(out_l, mesh, [role(i, Shard(0), Partial()) for i in dims], x.placements)

    # aux: me and ce of this rank's experts, summed over the batch's ranks
    rows = x_l.shape[0]
    stats = torch.stack([probs.sum(dim=(0, 1)),
                         F.one_hot(idx.reshape(rows, S * K), E).to(probs.dtype).sum(dim=(0, 1))])
    stats = from_parts(stats[:, lo:hi], mesh, [role(i, Partial(), Shard(1)) for i in dims],
                       [role(i, Replicate(), Shard(1)) for i in dims])
    me, ce = stats[0] / (B * S), stats[1] / (B * S * K)
    aux = (E * torch.sum(me * ce)).redistribute(mesh, [Replicate()] * mesh.ndim)

    for s in range(cfg.moe_shared):
        out = out + mlp_apply(p[f"shared_{s}"], x, cfg)
    return out.to(x.dtype), aux


_ROUTES = []  # the lists record_routes collects into, innermost last


def _record(idx: torch.Tensor) -> None:
    if _ROUTES:
        _ROUTES[-1].append(idx.detach().clone())


@contextmanager
def record_routes():
    """Collect the top-k expert indices ``[rows, S, K]`` of every
    :func:`moe_apply` call in the block, in call order, from any thread (a
    rematerialised forward calls again, in the backward's thread): on a
    mesh, each rank's own rows."""
    routes = []
    _ROUTES.append(routes)
    try:
        yield routes
    finally:
        _ROUTES.pop()
