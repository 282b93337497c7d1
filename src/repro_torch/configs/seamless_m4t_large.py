"""SeamlessM4T-Large v2 — encoder-decoder multimodal backbone.
[arXiv:2308.11596; hf]

Per the assignment sheet the modality frontend is a STUB: ``input_specs``
provides precomputed speech-frame embeddings as the encoder input; the
listed 24L/1024d/16H/8192ff backbone is instantiated as a 24-layer encoder
plus 24-layer decoder with cross-attention."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,           # decoder depth
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    act="silu",
    rope_theta=1e4,
    frontend="audio",
    frontend_tokens=0,     # encoder consumes frame embeddings directly
    notes="enc-dec; audio frontend stubbed with frame embeddings",
))
