"""Attention: GQA (dense + blockwise online-softmax) and MLA (DeepSeek-V2).

Prefill/training uses a double-chunked blockwise attention (online
softmax over query and key chunks) above a size threshold, keeping the
scores working set at ``B·Cq·H·Ckv``.  Decode attends densely over the KV
cache (one query row).

MLA implements the *absorbed* decode path: the cache stores only the
latent ``c_kv`` (+ rope key), queries are projected into the latent space,
and the value up-projection happens after the softmax.

As in the JAX package this is not a kernel: the scores are float32
products of float32 copies of q and k (the JAX package's
``preferred_element_type=f32``; a product of two bf16 values is exact in
float32; a float64 model stays in float64), the softmax runs in that
type and the probabilities are cast to v's dtype.  The decode cache is
written in place: the caller's cache tensors are the new cache (the JAX
engine donates its cache for the same effect).

On a mesh q, k and v are DTensors.  Attention is independent per batch
row and head, so :func:`_attend` constrains them to ``("batch", None,
"act_heads", None)`` (the batch over ``("pod", "data")``, the heads over
``model`` where their count divides it) and each rank runs the dense or
blockwise attention above on its own rows and heads, as plain tensors,
with the kv heads its q heads read (GQA's expansion is local); the output
keeps q's placements.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.configs.base import ModelConfig

from .layers import rope, wide
from .params import ParamDef, dtype_of, local_view, shard

__all__ = ["attention_defs", "attention_apply", "init_attn_cache", "ATTN_CACHE_LOGICAL"]

_DENSE_LIMIT = 1 << 22  # Sq*Skv above this -> blockwise path
_NEG = -1e30


def attention_defs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, ParamDef]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H = cfg.padded_heads
    if cfg.mla_kv_lora and not cross:
        r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
        return {
            "wq": ParamDef((d, H, hd + rd), ("embed", "heads", None)),
            "wkv_a": ParamDef((d, r + rd), ("embed", None)),
            "wk_b": ParamDef((r, H, hd), (None, "heads", None)),
            "wv_b": ParamDef((r, H, hd), (None, "heads", None)),
            "wo": ParamDef((H, hd, d), ("heads", None, "embed")),
        }
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((H, hd, d), ("heads", None, "embed")),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device, lead=()):
    """Zeroed decode cache (``lead``: leading stack dims)."""
    hd = cfg.resolved_head_dim
    z = lambda *shape: torch.zeros(lead + shape, dtype=dtype_of(cfg), device=device)
    if cfg.mla_kv_lora:
        return {"ckv": z(batch, max_len, cfg.mla_kv_lora), "kpe": z(batch, max_len, cfg.mla_rope_dim)}
    return {"k": z(batch, max_len, cfg.n_kv_heads, hd), "v": z(batch, max_len, cfg.n_kv_heads, hd)}


# logical axes of the decode cache's leaves (for their specs)
ATTN_CACHE_LOGICAL = {
    "ckv": ("cache_batch", None, "kv_embed"),
    "kpe": ("cache_batch", None, None),
    "k": ("cache_batch", None, "kv_heads", "head_dim"),
    "v": ("cache_batch", None, "kv_heads", "head_dim"),
}


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``bqhd,bthd->bhqt`` in float32 (the JAX package's f32 preferred type;
    float64 stays float64)."""
    return torch.einsum("bqhd,bthd->bhqt", wide(q), wide(k))


def _dense_attend(q, k, v, q_pos, k_pos, causal: bool, k_valid=None):
    """Flat-head attention.  q: [B,Sq,H,hd]; k: [B,Skv,H,hdk]; v: [B,Skv,H,hdv]."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    s = _scores(q, k) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if k_valid is not None:
        mask = mask & k_valid[None, :]
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype), v)


def _blockwise_attend(q, k, v, q_pos, k_pos, causal: bool, q_chunk=512, kv_chunk=1024):
    """Online-softmax double-chunked attention (flash-style, flat heads),
    the JAX package's two nested scans as two loops."""
    B, Sq, H, hd = q.shape
    Skv, hdv = k.shape[1], v.shape[-1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"chunks must divide the lengths: {(Sq, q_chunk, Skv, kv_chunk)}")
    scale = 1.0 / float(hd) ** 0.5
    outs = []
    for qs in range(0, Sq, q_chunk):
        qc, qpc = q[:, qs : qs + q_chunk], q_pos[qs : qs + q_chunk]
        m = torch.full((B, H, q_chunk), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, q_chunk, hdv), dtype=v.dtype, device=q.device)
        for ks in range(0, Skv, kv_chunk):
            kc, vc = k[:, ks : ks + kv_chunk], v[:, ks : ks + kv_chunk]
            kpc = k_pos[ks : ks + kv_chunk]
            s = _scores(qc, kc) * scale
            if causal:
                s = torch.where(qpc[:, None] >= kpc[None, :], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqt,bthd->bhqd", p.to(vc.dtype), vc)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-20)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 2, 1, 3))  # bhqd -> bqhd
    return torch.cat(outs, dim=1)


def _attend(q, k, v, q_pos, k_pos, causal, k_valid=None, groups=1):
    """Attention of q over k and v, whose heads serve ``groups`` q heads
    each (GQA: expanded here)."""
    if isinstance(q, DTensor):
        return _attend_local(q, k, v, q_pos, k_pos, causal, k_valid, groups)
    k, v = _expand_kv(k, groups), _expand_kv(v, groups)
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq * Skv <= _DENSE_LIMIT or Sq == 1:
        return _dense_attend(q, k, v, q_pos, k_pos, causal, k_valid)
    return _blockwise_attend(q, k, v, q_pos, k_pos, causal)


def _head_offset(t: DTensor) -> int:
    """The first head (dim 2) of ``t``'s local shard."""
    mesh, coord, off = t.device_mesh, t.device_mesh.get_coordinate(), 0
    for i, pl in enumerate(t.placements):
        if pl.is_shard(2):
            off = off * mesh.size(i) + coord[i]
    return off * t.to_local().shape[2]


def _attend_local(q, k, v, q_pos, k_pos, causal, k_valid=None, groups=1):
    """:func:`_attend` of DTensors: each rank over its own batch rows and
    q heads (the sequence and head dims whole), with the kv heads they
    read.  q is constrained to ``("batch", None, "act_heads", None)``, and
    so are k and v where their head count divides as q's does; where it
    does not (2 kv heads on a ``model`` axis of 4) they stay replicated
    over ``model`` and each rank reads its q heads' kv heads, their
    gradient a part over ``model`` of the rank's q heads."""
    q = shard(q, "batch", None, "act_heads", None)
    k, v = (shard(t, "batch", None, "act_heads", None) for t in (k, v))
    for t in (q, k, v):
        if not all(p.is_replicate() or p.is_shard(0) or p.is_shard(2) for p in t.placements):
            raise ValueError(f"attention over DTensors sharded as {t.placements} (q: "
                             f"{q.placements}); run it inside a sharding_ctx")
    grad = [Partial() if (pq.is_shard(2) and pk.is_replicate()) else pk
            for pq, pk in zip(q.placements, k.placements)]
    if any(pq != pk for pq, pk in zip(q.placements, k.placements)
           if not (pq.is_shard(2) and pk.is_replicate())):
        raise ValueError(f"attention: q placed as {q.placements}, k and v as {k.placements}")
    k_l, v_l = (local_view(t, t.placements, grad) for t in (k, v))
    q_l = q.to_local()
    # the rank's kv heads that its q heads [h0, h0 + n) read, expanded
    h0, n, k0 = _head_offset(q), q_l.shape[2], _head_offset(k)
    lo, hi = h0 // groups - k0, (h0 + n - 1) // groups + 1 - k0
    skip = h0 % groups
    k_l, v_l = (_expand_kv(t[:, :, lo:hi], groups)[:, :, skip:skip + n] for t in (k_l, v_l))
    out = _attend(q_l, k_l, v_l, q_pos, k_pos, causal, k_valid)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bsd,dhk->bshk`` as one product over the flattened heads: a flatten
    whose first dim is the sharded one, which DTensor carries on a mesh."""
    return (x @ w.flatten(1)).unflatten(-1, tuple(w.shape[1:]))


def _unheads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bqhd,hdo->bqo`` as one product over the flattened heads."""
    return o.flatten(-2) @ w.flatten(0, 1)


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B,S,KH,hd] -> [B,S,KH*G,hd] (GQA expansion, flat heads)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


# ---------------------------------------------------------------------------
# GQA / MLA apply
# ---------------------------------------------------------------------------


def _gqa(p, x, cfg: ModelConfig, pos0: int, cache, kv_x, causal, is_cross=False):
    B, S, _ = x.shape
    KH = cfg.n_kv_heads
    H = p["wq"].shape[1]  # padded head count (from the weights)
    G = H // KH
    q = _heads(x, p["wq"])
    q_pos = pos0 + torch.arange(S, device=x.device)
    is_cross = is_cross or kv_x is not None
    k_valid = None

    if is_cross and cache is not None and S == 1:
        # cross-attention decode: cache holds the encoder K/V, read-only
        k, v = cache["k"], cache["v"]
        k_pos = torch.arange(k.shape[1], device=x.device)
    elif is_cross and cache is not None:
        # cross-attention prefill: compute encoder K/V once, store them
        # (the rest of the cache zeroed, as the JAX package pads)
        k = _heads(kv_x, p["wk"])
        v = _heads(kv_x, p["wv"])
        n = k.shape[1]
        for name, t in (("k", k), ("v", v)):
            cache[name][:, :n] = t.to(cache[name].dtype)
            cache[name][:, n:] = 0
        k_pos = torch.arange(n, device=x.device)
    else:
        src = kv_x if is_cross else x
        k = _heads(src, p["wk"])
        v = _heads(src, p["wv"])
        if not is_cross:
            q = rope(q, q_pos, cfg.rope_theta)
            k = rope(k, q_pos, cfg.rope_theta)
        k_pos = q_pos
        if cache is not None:
            cache["k"][:, pos0 : pos0 + S] = k.to(cache["k"].dtype)
            cache["v"][:, pos0 : pos0 + S] = v.to(cache["v"].dtype)
            if S == 1:  # decode: attend over the whole cache, mask invalid
                k, v = cache["k"], cache["v"]
                k_pos = torch.arange(k.shape[1], device=x.device)
                k_valid = k_pos <= pos0
            # prefill: attend over the fresh keys only

    out = _attend(q, k.to(q.dtype), v.to(q.dtype), q_pos, k_pos, causal and not is_cross,
                  k_valid, G)
    y = _unheads(out, p["wo"])
    return y, cache


def _mla(p, x, cfg: ModelConfig, pos0: int, cache, causal):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = p["wq"].shape[1]
    r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
    q_pos = pos0 + torch.arange(S, device=x.device)

    qfull = _heads(x, p["wq"])
    q_nope, q_pe = qfull[..., :hd], rope(qfull[..., hd:], q_pos, cfg.rope_theta, head_axes=1)
    ckv_full = x @ p["wkv_a"]
    c_kv, k_pe = ckv_full[..., :r], rope(ckv_full[..., r:], q_pos, cfg.rope_theta, head_axes=0)

    if cache is not None:
        cache["ckv"][:, pos0 : pos0 + S] = c_kv.to(cache["ckv"].dtype)
        cache["kpe"][:, pos0 : pos0 + S] = k_pe.to(cache["kpe"].dtype)

    if cache is not None and S == 1:
        # absorbed decode: stay in the latent space
        ckv_t, kpe_t = cache["ckv"], cache["kpe"]
        Skv = ckv_t.shape[1]
        scale = 1.0 / float(hd + rd) ** 0.5
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, p["wk_b"])
        s = (
            torch.einsum("bqhr,btr->bhqt", wide(q_lat), wide(ckv_t))
            + torch.einsum("bqhp,btp->bhqt", wide(q_pe), wide(kpe_t))
        ) * scale
        valid = torch.arange(Skv, device=x.device) <= pos0
        s = torch.where(valid[None, None, None, :], s, _NEG)
        attn = torch.softmax(s, dim=-1)
        lat = torch.einsum("bhqt,btr->bqhr", attn.to(ckv_t.dtype), ckv_t)
        heads = torch.einsum("bqhr,rhd->bqhd", lat, p["wv_b"])
    else:
        # train/prefill: expand per-head keys/values from the latent
        k_nope = _heads(c_kv, p["wk_b"])
        vv = _heads(c_kv, p["wv_b"])
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, rd)], -1)
        q = torch.cat([q_nope, q_pe], -1)  # [B,S,H,hd+rd]
        heads = _attend(q, k.to(q.dtype), vv.to(q.dtype), q_pos, q_pos, causal)
    y = _unheads(heads, p["wo"])
    return y, cache


def attention_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    pos0: int = 0,
    cache: Optional[Dict] = None,
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    cross: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention with optional decode cache.

    ``cross=True`` (or a ``kv_x``) switches to cross-attention: K/V come
    from the encoder output at prefill and from the read-only cache at
    decode.  Returns ``(y, cache)``: the cache given, written in place.
    """
    if cfg.mla_kv_lora and not cross and kv_x is None:
        return _mla(p, x, cfg, pos0, cache, causal)
    return _gqa(p, x, cfg, pos0, cache, kv_x, causal, is_cross=cross)
