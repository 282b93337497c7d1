# Checkpoints in the JAX package's on-disk layout (each package restores
# the other's), with async saves and atomic renames.
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
