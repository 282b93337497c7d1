"""Mistral-NeMo 12B — dense GQA, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,  # explicit: 5120/32=160 but NeMo pins head_dim=128
    d_ff=14336,
    vocab=131072,
    act="silu",
    rope_theta=1e6,
    notes="GQA kv=8, 128k ctx, Tekken 131k vocab",
))
