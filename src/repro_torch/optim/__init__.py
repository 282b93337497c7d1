# Optimizers of the port: AdamW (warmup + cosine schedule, global-norm
# clipping, f32 or int8 moments), stepped alike with the JAX package's, and
# top-k gradient compression with error feedback.
from .adamw import (
    AdamWConfig,
    QTensor,
    adamw_update,
    init_opt_state,
    load_opt_state,
    lr_schedule,
    opt_state_specs,
)
from .compression import TopKCompressor

__all__ = [
    "AdamWConfig",
    "QTensor",
    "TopKCompressor",
    "adamw_update",
    "init_opt_state",
    "load_opt_state",
    "lr_schedule",
    "opt_state_specs",
]
