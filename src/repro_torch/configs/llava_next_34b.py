"""LLaVA-NeXT 34B — VLM: anyres tiling, Hermes-Yi-34B backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf family; unverified]
The vision tower is a STUB: ``input_specs`` provides precomputed patch
embeddings (anyres tiles -> up to ``frontend_tokens`` patches) that the
model scatters at the start of the sequence."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    act="silu",
    rope_theta=5e6,
    frontend="vision",
    frontend_tokens=2880,  # anyres: 5 tiles x 576 CLIP patches
    notes="GQA kv=8; vision frontend stubbed with patch embeddings",
))
