# The deterministic synthetic token stream (numpy, seekable by step).
from .pipeline import DataConfig, SyntheticLM, make_global_batch

__all__ = ["DataConfig", "SyntheticLM", "make_global_batch"]
