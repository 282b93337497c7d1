"""Parameter definition trees, their materialisation on a device, and the
carry of the JAX package's parameters.

Every layer contributes a nested dict of :class:`ParamDef` leaves, each
naming its dimensions with *logical* axes ("embed", "heads", "mlp", ...)
as in the JAX package, so that the two packages' trees have the same keys
and shapes leaf for leaf.  Two materialisations:

* :func:`init_params` — tensors on a device from a ``torch.Generator``;
* :func:`params_from_arrays` — the JAX package's parameter tree, given as
  nested dicts of numpy arrays, carried across key for key.

The JAX package maps the logical axes onto a TPU mesh; on one card
:func:`shard` and :func:`constrain_defs` are identities, kept for code
written against the JAX package's surface; the port's layers call neither.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

__all__ = [
    "ParamDef",
    "init_params",
    "params_from_arrays",
    "stack_defs",
    "tree_map",
    "dtype_of",
    "shard",
    "constrain_defs",
]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | a_log | const:<value>
    scale: Optional[float] = None  # stddev override for "normal"

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name (``"float64"`` too, for
    a reference computed wholly in float64)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}[cfg.dtype]


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (``rest``: trees of the
    same structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def stack_defs(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dimension (the per-group parameter stacks)."""
    return tree_map(
        lambda d: dataclasses.replace(
            d, shape=(n,) + d.shape, logical=(axis_name,) + d.logical
        ),
        tree,
    )


def _leaf_seed(base: int, path: Tuple[str, ...]) -> int:
    # zlib.crc32 is the same in every process (str hashes are salted)
    return (base * 0x9E3779B1 + zlib.crc32("/".join(path).encode())) % (2**63 - 1)


def init_params(tree, generator: torch.Generator, *, dtype=torch.float32, device=None):
    """Materialise a def tree into tensors on ``device`` (default: the card).

    Deterministic: one draw from ``generator`` keys the tree, and every
    leaf's stream is seeded from that key and a ``zlib.crc32`` of its path,
    independent of dict ordering and of the process.  Kinds as in the JAX
    package: ``normal`` is a normal truncated at ±2σ with σ = ``scale`` or
    1/√fan_in (fan_in the last-but-one dim), ``zeros``, ``ones``,
    ``a_log`` (log of 1..16 over the last dim) and ``const:<value>``.  The
    random numbers differ from ``jax.random``'s; carry the JAX package's
    weights with :func:`params_from_arrays` to compare the two.
    """
    dev = resolve_device(device)
    base = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device).item())

    def make(path, d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "a_log":  # Mamba A init: A = -exp(A_log) in [-16, -1]
            row = torch.log(torch.linspace(1.0, 16.0, d.shape[-1], device=dev))
            return row.expand(d.shape).to(dtype).contiguous()
        if d.init.startswith("const:"):
            return torch.full(d.shape, float(d.init.split(":")[1]), dtype=dtype, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        g = torch.Generator(device=dev).manual_seed(_leaf_seed(base, path))
        w = torch.empty(d.shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
        return (w * std).to(dtype)

    return _map_with_path(make, tree)


def params_from_arrays(tree, device=None, dtype=None):
    """The JAX package's parameter tree as tensors on ``device`` (default:
    the card), key for key.

    ``tree`` holds numpy arrays (``jax.tree.map(np.asarray, params)``).
    JAX's bf16 arrays come out as ``ml_dtypes.bfloat16``, which torch cannot
    read: they go through float32 (exact, bf16 ⊂ f32) back to bf16.
    ``dtype`` casts every leaf; by default each keeps its own.
    """
    dev = resolve_device(device)

    def one(a) -> torch.Tensor:
        a = np.asarray(a)
        want = dtype
        if a.dtype.name == "bfloat16":
            want = want or torch.bfloat16
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, order="C")).to(dev)  # a writable copy
        return t.to(want) if want is not None else t

    return tree_map(one, tree)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Identity on one card (the JAX package constrains x to a mesh here)."""
    return x


def constrain_defs(tree: Any, defs_tree: Any) -> Any:
    """Identity on one card (the JAX package pins stacked weights to their
    mesh layout here)."""
    return tree
