"""OLMo-1B — dense, non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    act="silu",
    norm="nonparam_ln",  # OLMo: LayerNorm without learnable scale/bias
    rope_theta=1e4,
    tie_embeddings=True,
    notes="MHA (kv=16), non-parametric LN",
))
