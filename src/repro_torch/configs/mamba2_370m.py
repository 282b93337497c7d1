"""Mamba2-370M — attention-free SSM with state-space duality (SSD).
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,  # Mamba-2 blocks carry their own 2x expansion
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    notes="SSD chunked scan; O(1)-state decode -> runs long_500k",
))
