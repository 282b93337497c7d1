# LM serving: prefill/decode steps and the batched engine.
from .steps import make_decode_step, make_prefill_step
