"""Nemotron-4 340B — dense GQA with squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    act="relu2",  # squared ReLU, non-gated MLP
    rope_theta=1e4,
    notes="GQA kv=8, squared-ReLU; the largest dense arch in the pool",
))
