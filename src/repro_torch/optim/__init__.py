# Optimizers of the port: AdamW (warmup + cosine schedule, global-norm
# clipping, f32 or int8 moments), stepped alike with the JAX package's.
from .adamw import (
    AdamWConfig,
    QTensor,
    adamw_update,
    init_opt_state,
    load_opt_state,
    lr_schedule,
)

__all__ = [
    "AdamWConfig",
    "QTensor",
    "adamw_update",
    "init_opt_state",
    "load_opt_state",
    "lr_schedule",
]
