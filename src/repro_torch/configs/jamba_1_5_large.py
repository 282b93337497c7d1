"""Jamba-1.5-Large 398B — hybrid Mamba+attention (1:7) with MoE 16e top-2.
[arXiv:2403.19887; hf]

Layer pattern (period 8): attention at offset 4 inside every 8-layer block
(1 attention : 7 mamba), MoE replaces the dense FFN in every 2nd layer."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    act="silu",
    rope_theta=1e6,
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_chunk=256,
    attn_every=8,
    attn_offset=4,
    notes="Mamba+attn 1:7 interleave, MoE every 2nd layer; runs long_500k",
))
