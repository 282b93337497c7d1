"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

All layers are plain functions ``apply(params, x, cfg, ...)`` over nested
dicts of tensors, with the JAX package's parameter layout, so the carried
weights map 1:1.  Math in the parameters' dtype with float32 where the
JAX package asks for it (norms, rotary angles, logits); a float64 model
keeps float64 there (:func:`wide`), so that it can serve as a reference
computed wholly in float64.  None of this is a Pallas kernel in the JAX
package; it stays PyTorch code here.

On a mesh the activations are DTensors: the constant tables (the rotary
angles, the padded-vocab mask) become replicated DTensors beside them
(:func:`~.params.replicate_like`), and :func:`embed_apply` and
:func:`logits_apply` constrain their outputs with
:func:`~.params.shard` where the JAX package does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .params import ParamDef, replicate_like, shard

__all__ = [
    "grad_dtype_guard",
    "rmsnorm",
    "nonparam_layernorm",
    "norm_defs",
    "apply_norm",
    "rope",
    "mlp_defs",
    "mlp_apply",
    "embed_defs",
    "embed_apply",
    "logits_apply",
]


class _GradDtypeGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_dtype_guard(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts the gradient back to x's dtype in backward.

    The score products run in float32, so their gradients come back in
    float32; clamping the residual stream's gradient at each block
    boundary keeps the backward in the working dtype while the softmax
    math stays float32 (the JAX package's ``custom_vjp`` of the same name).
    """
    return _GradDtypeGuard.apply(x)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in its own dtype where that is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *, mean_sq=None) -> torch.Tensor:
    """RMSNorm over the last dim; ``mean_sq(xf)`` (default: the mean of
    ``xf * xf``) may reduce over ranks holding parts of that dim."""
    xf = wide(x)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True) if mean_sq is None else mean_sq(xf)
    rms = torch.rsqrt(ms + eps)
    return ((xf * rms) * wide(w)).to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no learnable scale or bias."""
    xf = wide(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    if cfg.norm == "nonparam_ln":
        return {}
    return {"w": ParamDef((cfg.d_model,), ("embed",), init="ones")}


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "nonparam_ln":
        return nonparam_layernorm(x)
    return rmsnorm(x, p["w"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, head_axes: int = 1) -> torch.Tensor:
    """Rotary embedding over the last dim.

    ``positions`` ([S] or [B, S]) aligns with x's sequence dim;
    ``head_axes`` is the number of head dims between sequence and head_dim
    (1 for [B,S,H,hd], 0 for the headless MLA rope key [B,S,rd])."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # pos.shape + [half]
    ang = ang.reshape(ang.shape[:-1] + (1,) * head_axes + (half,))
    cos, sin = replicate_like(torch.cos(ang), x), replicate_like(torch.sin(ang), x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "relu2":  # non-gated (Nemotron-4 squared ReLU)
        return {
            "w1": ParamDef((d, f), ("embed", "mlp")),
            "w2": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "wg": ParamDef((d, f), ("embed", "mlp")),
        "w1": ParamDef((d, f), ("embed", "mlp")),
        "w2": ParamDef((f, d), ("mlp", "embed")),
    }


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(h)
    if act == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if act == "relu2":
        r = torch.clamp_min(h, 0.0)
        return r * r
    raise ValueError(f"unknown activation {act!r}")


def mlp_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "relu2":
        return _activate(x @ p["w1"], "relu2") @ p["w2"]
    return (_activate(x @ p["wg"], cfg.act) * (x @ p["w1"])) @ p["w2"]


# ---------------------------------------------------------------------------
# Embeddings / logits
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    v = cfg.padded_vocab
    defs = {"tok": ParamDef((v, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, v), ("embed", "vocab"), scale=0.02)
    return defs


def embed_apply(p: Dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if tokens.shape[-1] == 1:  # decode: one token, no gradient, a gather
        x = p["tok"][tokens]
    else:
        # train/prefill: the JAX package's one-hot contraction, whose
        # gradient is a (sharded) matmul where a gather's is a scatter-add
        # into the whole table; each output row is one product 1·x plus
        # zeros, the gather's value
        iota = torch.arange(p["tok"].shape[0], device=tokens.device)
        onehot = (tokens[..., None] == replicate_like(iota, tokens)).to(p["tok"].dtype)
        x = onehot @ p["tok"]
    return shard(x, "batch", "seq", "act_embed")


def logits_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = shard(wide(x @ w), "batch", "seq", "vocab")
    if cfg.padded_vocab != cfg.vocab:
        # mask pad columns: no effect on CE's logsumexp, never sampled; in
        # place, each rank on its own columns of a vocab dim sharded over
        # "model" (constrained first: a product may leave partial sums)
        pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
        logits.masked_fill_(replicate_like(pad, logits), -1e30)
    return logits
