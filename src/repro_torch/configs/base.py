"""Model configuration system (plain data, a copy of the JAX package's).

One :class:`ModelConfig` describes every architecture of the pool (dense /
MoE / MLA / SSM / hybrid / enc-dec / VLM / audio).  Each
``src/repro_torch/configs/<arch>.py`` exports ``CONFIG`` (the exact
published configuration) and the registry maps ``--arch <id>`` to it.
``smoke()`` derives the reduced same-family configuration of the per-arch
CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config", "ARCHS"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    act: str = "silu"  # silu (SwiGLU) | gelu | relu2 (squared ReLU, non-gated)
    norm: str = "rmsnorm"  # rmsnorm | nonparam_ln (OLMo)
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0  # shared (always-on) experts, DeepSeek-style
    moe_every: int = 1  # MoE replaces dense FFN in every k-th layer
    moe_first_dense: int = 0  # first k layers keep dense FFN (DeepSeek-V2)
    first_dense_ff: int = 0  # FFN width of those first dense layers (0 = d_ff)
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    mla_kv_lora: int = 0
    mla_rope_dim: int = 64
    # --- SSM (Mamba-2 SSD; also used by hybrid layers) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: attention replaces SSM in every k-th layer
    attn_offset: int = 0  # position of the attention layer inside the period
    # --- encoder-decoder ---
    encoder_layers: int = 0  # >0 => enc-dec; n_layers is the decoder depth
    # --- modality frontend (STUB: input_specs provide embeddings) ---
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0  # patch/frame embeddings prepended to the sequence
    # --- numerics / compilation ---
    dtype: str = "bfloat16"
    scan_layers: bool = True
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def padded_heads(self) -> int:
        """Query heads padded to divide a 16-wide model axis (and stay a
        multiple of the KV-head count), as the JAX package shards them:
        llava-next's published 56 heads become 64.  Padding follows
        standard Megatron practice; a converted checkpoint zero-pads
        wq/wo.  Kept on one card so that parameter trees map 1:1."""
        h, kv = self.n_heads, max(self.n_kv_heads, 1)
        if h == 0:
            return 0
        step = 16
        while step % kv:
            step += 16
        if h % 16 == 0 and h % kv == 0:
            return h
        return -(-h // step) * step

    @property
    def ssm_inner(self) -> int:
        """The SSM's inner width, ``ssm_expand * d_model``."""
        return self.ssm_expand * self.d_model

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the JAX package shards
        the vocab dim over a model axis; odd vocabs such as granite 49155,
        mamba2 50280 and seamless 256206 would not divide).  Padded logit
        columns are masked to -1e30 in ``logits_apply``."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if the arch supports O(1)-state long-context decode
        (SSM / hybrid); pure full-attention archs skip ``long_500k``."""
        return self.family in ("ssm", "hybrid")

    @property
    def layer_period(self) -> int:
        """Smallest repeating layer pattern — the scan group size."""
        period = 1
        if self.moe_experts and self.moe_every > 1:
            period = _lcm(period, self.moe_every)
        if self.attn_every > 1:
            period = _lcm(period, self.attn_every)
        return period

    def layer_kind(self, l: int) -> Tuple[str, str]:
        """(mixer, ffn) of layer ``l``.

        mixer: "attn" | "mamba";  ffn: "dense" | "moe" | "none".
        """
        if self.family == "ssm":
            mixer = "mamba"
        elif self.attn_every > 1:
            mixer = "attn" if l % self.attn_every == self.attn_offset else "mamba"
        else:
            mixer = "attn"
        if self.family == "ssm":
            ffn = "none"  # Mamba-2 blocks carry their own expansion
        elif self.moe_experts and l >= self.moe_first_dense and l % self.moe_every == (self.moe_every - 1 if self.moe_every > 1 else 0):
            ffn = "moe"
        else:
            ffn = "dense"
        return mixer, ffn

    def param_count(self) -> int:
        """Total parameters N."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: shared + top-k experts)."""
        return _count_params(self, active_only=True)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = self.layer_period
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, 2 * period),
            encoder_layers=2 if self.is_encdec else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            moe_shared=min(self.moe_shared, 1),
            mla_kv_lora=32 if self.mla_kv_lora else 0,
            mla_rope_dim=8 if self.mla_kv_lora else 64,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            capacity_factor=4.0,  # avoid routing drops in tiny smoke batches
            frontend_tokens=8 if self.frontend != "none" else 0,
            dtype="float32",
        )


def _lcm(a: int, b: int) -> int:
    from math import gcd

    return a * b // gcd(a, b)


def _count_params(cfg: ModelConfig, *, active_only: bool) -> int:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim
    n = v * d  # embedding
    if not cfg.tie_embeddings:
        n += v * d  # output head

    def attn_params() -> int:
        if cfg.mla_kv_lora:
            r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
            p = d * cfg.n_heads * (hd + rd)  # q (nope + rope)
            p += d * (r + rd)  # kv down-projection + k rope
            p += r * cfg.n_heads * (hd + hd)  # k/v up-projections
            p += cfg.n_heads * hd * d  # out
            return p
        p = d * cfg.n_heads * hd  # q
        p += 2 * d * cfg.n_kv_heads * hd  # k, v
        p += cfg.n_heads * hd * d  # out
        return p

    def mamba_params() -> int:
        di = cfg.ssm_expand * d
        nh = di // cfg.ssm_head_dim
        p = d * (2 * di + 2 * cfg.ssm_state + nh)  # in_proj: x, z, B, C, dt
        p += di * cfg.ssm_conv  # depthwise conv
        p += nh * 2  # A_log, D
        p += di  # gate norm
        p += di * d  # out_proj
        return p

    def ffn_params(kind: str, layer: int = 10**9) -> int:
        gated = cfg.act != "relu2"
        width = f
        if kind == "dense" and cfg.first_dense_ff and layer < cfg.moe_first_dense:
            width = cfg.first_dense_ff
        per_ffn = d * width * (3 if gated else 2)
        if kind == "dense":
            return per_ffn
        total_experts = cfg.moe_experts + cfg.moe_shared
        active_experts = cfg.moe_top_k + cfg.moe_shared
        router = d * cfg.moe_experts
        if active_only:
            return router + active_experts * per_ffn
        return router + total_experts * per_ffn

    layers = 0
    for l in range(cfg.n_layers):
        mixer, ffn = cfg.layer_kind(l)
        layers += attn_params() if mixer == "attn" else mamba_params()
        if ffn != "none":
            layers += ffn_params(ffn, l)
        layers += 2 * d if cfg.norm == "rmsnorm" else 0
    if cfg.is_encdec:
        enc = cfg.encoder_layers * (attn_params() + ffn_params("dense") + 2 * d)
        cross = cfg.n_layers * attn_params()  # decoder cross-attention
        layers += enc + cross
    return n + layers


# ---------------------------------------------------------------------------
# Input shapes (assigned to every architecture in the pool)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


ARCHS: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the configs package so every <arch>.py registers itself
    from repro_torch import configs as _  # noqa: F401

    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
