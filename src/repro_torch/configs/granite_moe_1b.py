"""Granite-3.0 1B-A400M — fine-grained MoE, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,  # per-expert FFN width
    vocab=49155,
    act="silu",
    rope_theta=1e4,
    moe_experts=32,
    moe_top_k=8,
    tie_embeddings=True,
    notes="32 experts top-8, d_ff=512 per expert",
))
