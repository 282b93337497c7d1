# LM training: the loss, the train step (microbatching, remat, AdamW) and
# the trainer with checkpoints and the synthetic data stream.
from .steps import init_train_state, loss_fn, make_train_step

__all__ = ["loss_fn", "make_train_step", "init_train_state"]
