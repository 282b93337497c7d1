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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

from .layers import rope, wide
from .params import ParamDef, dtype_of

__all__ = ["attention_defs", "attention_apply", "init_attn_cache"]

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


def _attend(q, k, v, q_pos, k_pos, causal, k_valid=None):
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq * Skv <= _DENSE_LIMIT or Sq == 1:
        return _dense_attend(q, k, v, q_pos, k_pos, causal, k_valid)
    return _blockwise_attend(q, k, v, q_pos, k_pos, causal)


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
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
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
        k = torch.einsum("bsd,dhk->bshk", kv_x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", kv_x, p["wv"])
        n = k.shape[1]
        for name, t in (("k", k), ("v", v)):
            cache[name][:, :n] = t.to(cache[name].dtype)
            cache[name][:, n:] = 0
        k_pos = torch.arange(n, device=x.device)
    else:
        src = kv_x if is_cross else x
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
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

    kf = _expand_kv(k.to(q.dtype), G)
    vf = _expand_kv(v.to(q.dtype), G)
    out = _attend(q, kf, vf, q_pos, k_pos, causal and not is_cross, k_valid)
    y = torch.einsum("bqhd,hdo->bqo", out, p["wo"])
    return y, cache


def _mla(p, x, cfg: ModelConfig, pos0: int, cache, causal):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = p["wq"].shape[1]
    r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
    q_pos = pos0 + torch.arange(S, device=x.device)

    qfull = torch.einsum("bsd,dhk->bshk", x, p["wq"])
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
        k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["wk_b"])
        vv = torch.einsum("bsr,rhd->bshd", c_kv, p["wv_b"])
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, rd)], -1)
        q = torch.cat([q_nope, q_pe], -1)  # [B,S,H,hd+rd]
        heads = _attend(q, k.to(q.dtype), vv.to(q.dtype), q_pos, q_pos, causal)
    y = torch.einsum("bqhd,hdo->bqo", heads, p["wo"])
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
