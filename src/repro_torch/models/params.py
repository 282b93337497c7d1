"""Parameter definition trees, their materialisation on a device, and the
carry of the JAX package's parameters.

Every layer contributes a nested dict of :class:`ParamDef` leaves, each
naming its dimensions with *logical* axes ("embed", "heads", "mlp", ...)
as in the JAX package, so that the two packages' trees have the same keys
and shapes leaf for leaf.  Three materialisations:

* :func:`init_params` — tensors on a device from a ``torch.Generator``;
* :func:`params_from_arrays` — the JAX package's parameter tree, given as
  nested dicts of numpy arrays, carried across key for key;
* :func:`abstract_params` — empty tensors (``meta`` by default) of each
  def's shape, for a dry run that allocates nothing.

Sharding rules (:class:`Rules`) map logical axes to mesh axes ("pod",
"data", "model") as the JAX package's do, table for table.
:func:`logical_spec` turns a shape and its logical axes into a spec, the
counterpart of a ``PartitionSpec``: a tuple with one entry per dim, each
``None``, a mesh axis name or a tuple of names.  An axis is skipped where
the mesh lacks it, an earlier dim took it, or its size does not divide the
dim.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or an :class:`AbstractMesh` (shape only, the
counterpart of ``jax.sharding.AbstractMesh``); :func:`mesh_shape` reads
either.

The port runs the LM on one card.  :func:`shard` and
:func:`constrain_defs` are identities outside a :func:`sharding_ctx` and
inside one on a mesh of one device; on a mesh of more devices they raise
``NotImplementedError`` (ROADMAP.md, item C), as does :func:`place` for a
:class:`NamedSharding` on such a mesh.  The port's layers call neither.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import zlib
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

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
    "abstract_params",
    "AbstractMesh",
    "mesh_shape",
    "mesh_size",
    "Rules",
    "TRAIN_RULES",
    "TRAIN_RULES_SP",
    "DECODE_RULES",
    "logical_spec",
    "param_specs",
    "NamedSharding",
    "place",
    "require_one_device",
    "sharding_ctx",
    "get_sharding_ctx",
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


def abstract_params(tree, dtype=torch.bfloat16, device="meta"):
    """Empty tensors of each def's shape in ``dtype`` on ``device`` (``meta``
    by default: nothing is allocated), built from the defs alone."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device=device), tree)


# ---------------------------------------------------------------------------
# Meshes and sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of shape only: axis sizes and names, no devices."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} vs names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of an :class:`AbstractMesh` or a named ``DeviceMesh``
    (whose own ``shape`` is a tuple, its names in ``mesh_dim_names``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to carry sharding rules")
    return dict(zip(names, tuple(mesh.shape)))


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axis mapping; ``name`` keys the dry-run records."""

    name: str
    table: Dict[str, Any]  # logical -> mesh axis (str | tuple | None)

    def get(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.table.get(logical)


# Training: tensor parallelism over "model" (heads / mlp / experts / vocab),
# FSDP-style weight sharding over "data" on the embed dim, pure data
# parallelism over "pod".
TRAIN_RULES = Rules(
    "fsdp_tp",
    {
        "vocab": "model",
        "embed": ("pod", "data"),
        "heads": "model",
        "kv_heads": "model",  # divisibility-checked; kv=8 falls back to None
        "mlp": "model",
        "experts": "model",  # expert parallelism
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_conv_ch": "model",
        "batch": ("pod", "data"),
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_experts": "model",
        "seq": None,  # "model" under TRAIN_RULES_SP
        "kv_embed": "model",
        "cache_batch": ("pod", "data"),
        "head_dim": None,
    },
)

# Sequence-parallel training: activations (and so the stored remat
# boundaries) also sharded over "model" on the sequence dim.
TRAIN_RULES_SP = Rules("fsdp_tp_sp", dict(TRAIN_RULES.table, seq="model"))

# Serving/decode: weights fully sharded over (data, model); the KV cache
# shards batch over "data" and head_dim/latent over "model".
DECODE_RULES = Rules(
    "decode_fullshard",
    {
        "vocab": "model",
        "embed": "data",
        "heads": "model",
        "kv_heads": None,
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_conv_ch": "model",
        "batch": ("pod", "data"),
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_experts": "model",
        "seq": None,
        "kv_embed": "model",
        "cache_batch": ("pod", "data"),
        "head_dim": "model",
    },
)


def logical_spec(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...], rules: Rules,
                 mesh) -> Tuple:
    """The spec of a tensor: one entry per dim, skipping mesh axes that are
    absent, already used by an earlier dim, or do not divide the dim."""
    sizes = mesh_shape(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name)
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        # ("pod", "data") degrades to ("data",) on a mesh without "pod"
        avail = tuple(a for a in axes if a in sizes and a not in used)
        size = math.prod(sizes[a] for a in avail)
        if not avail or dim % size != 0:
            out.append(None)
            continue
        used.update(avail)
        out.append(avail if len(avail) > 1 else avail[0])
    return tuple(out)


def param_specs(tree, rules: Rules, mesh):
    """The spec of every def of a tree."""
    return tree_map(lambda d: logical_spec(d.shape, d.logical, rules, mesh), tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Tuple


def require_one_device(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` for a mesh of more than one device."""
    n = mesh_size(mesh)
    if n > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {n} devices: the port runs the LM on one card "
            "(ROADMAP.md, item C: the LM on more than one card)")


def place(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``t`` on the device of ``sharding``'s mesh, which must hold one device
    (a ``DeviceMesh``: an :class:`AbstractMesh` has no devices)."""
    require_one_device(sharding.mesh, "placing a tensor")
    if isinstance(sharding.mesh, AbstractMesh):
        raise ValueError("an AbstractMesh has no devices to place a tensor on")
    return t.to(sharding.mesh.device_type)


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextmanager
def sharding_ctx(mesh, rules: Rules):
    """Activate ``(mesh, rules)`` for :func:`shard` and :func:`constrain_defs`."""
    prev = getattr(_CTX, "v", None)
    _CTX.v = (mesh, rules)
    try:
        yield
    finally:
        _CTX.v = prev


def get_sharding_ctx():
    return getattr(_CTX, "v", None)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Identity outside a :func:`sharding_ctx` and on a mesh of one device;
    raises on a larger mesh (the JAX package constrains x to it here)."""
    ctx = get_sharding_ctx()
    if ctx is not None:
        require_one_device(ctx[0], "shard")
    return x


def constrain_defs(tree: Any, defs_tree: Any) -> Any:
    """Identity outside a :func:`sharding_ctx` and on a mesh of one device;
    raises on a larger mesh (the JAX package pins stacked weights to their
    mesh layout here)."""
    ctx = get_sharding_ctx()
    if ctx is not None:
        require_one_device(ctx[0], "constrain_defs")
    return tree
