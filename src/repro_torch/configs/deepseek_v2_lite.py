"""DeepSeek-V2-Lite 16B — MLA (kv_lora=512) + MoE 64 routed top-6 + 2 shared.
[arXiv:2405.04434; hf]

Note: 160 routed experts is the *full* V2 configuration — V2-Lite (16B)
has 64 routed experts, which is what this configuration holds."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert width (dense layer-0 FFN is 10944 -> see notes)
    vocab=102400,
    act="silu",
    rope_theta=1e4,
    moe_experts=64,
    moe_top_k=6,
    moe_shared=2,
    moe_first_dense=1,  # layer 0 keeps a dense FFN
    first_dense_ff=10944,
    mla_kv_lora=512,
    mla_rope_dim=64,
    notes="MLA kv_lora=512; MoE 64e top-6 + 2 shared; layer0 dense",
))
