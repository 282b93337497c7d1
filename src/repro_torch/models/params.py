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

On a ``DeviceMesh`` a tensor is a ``torch.distributed.tensor.DTensor``:
:func:`placements` maps a spec to one placement per mesh dim (``Shard(d)``
where the spec puts tensor dim ``d`` on that mesh axis, ``Replicate()``
elsewhere; a tuple such as ``("pod", "data")`` shards one dim over several
mesh axes, major to minor, as ``jax.sharding`` does), and :func:`place`
distributes a tensor to a :class:`NamedSharding` from rank 0.  Inside a
:func:`sharding_ctx`, :func:`shard` and :func:`constrain_defs` redistribute
a DTensor to its ``logical_spec`` (the counterparts of the JAX package's
``with_sharding_constraint``); outside one they are identities.  Inside a
context on a mesh of more than one device a plain tensor raises: a layer
got an input that was never placed.  The layers make their constant tables
(rotary angles, masks, iotas) DTensors with :func:`replicate_like`.

Where DTensor has no sharding rule for a layer's ops (the MoE routing's
sorts and gathers, the SSM's conv and scan), the layer runs on each
rank's local tensors between :func:`local_view` and :func:`from_parts`.
Inside such a region a value every rank of a mesh dim computes alike (a
replicated value) carries a *partial* gradient over that dim (each rank
the part its own experts, heads or channels add; their sum is the
gradient), and a value of the rank's own (its rows, experts, channels)
carries its whole gradient.  :func:`local_view` enters a region with the
gradient's placements named (``Partial()`` where it is summed over the
ranks), :func:`psum_local` sums a rank's part over mesh dims (its
gradient summed too) and :func:`from_parts` leaves it, summing the parts
into a DTensor (its gradient replicated over the summed dims, whatever
placement it arrives in).

Collectives go where the mesh's process group carries them.
:func:`collective_route` is the one place that picks a route: a gloo group
on the card takes DTensor's all-gather (``Shard -> Replicate``) through
c10d's ``all_gather_into_tensor`` (:func:`c10d_all_gathers`), because the
functional all-gather that DTensor calls kills a gloo rank on CUDA tensors
(a segfault, torch 2.11: ``scripts/gloo_cuda_collectives.py``).  The route
is kept per process group: NCCL, and gloo on the CPU, keep the functional
collective in the same process.  Reduce-scatter,
all-reduce and all-to-all keep theirs on every backend.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

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
    "placements",
    "place",
    "replicate_like",
    "collective_route",
    "c10d_all_gathers",
    "sharding_ctx",
    "get_sharding_ctx",
    "shard",
    "constrain_defs",
    "local_view",
    "from_parts",
    "psum_local",
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


def placements(spec: Tuple, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on a named ``DeviceMesh``: one per
    mesh dim, ``Shard(d)`` where the spec puts tensor dim ``d`` on that
    mesh axis, ``Replicate()`` elsewhere.  A dim sharded over several axes
    splits over them major to minor, which DTensor does in mesh order: they
    must appear in the spec in the mesh's order.  An axis of size 1 holds
    the whole tensor whatever the spec says: it is ``Replicate()``."""
    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"{entry!r} shards dim {dim} over mesh axes out of the mesh's "
                             f"order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


_AG = "_c10d_functional::all_gather_into_tensor"
_C10D_GROUPS: set = set()  # names of the groups whose all-gathers take c10d's collective
_ROUTED: Dict[str, Any] = {}  # device type -> (the registration, the functional kernel)


def _group_name(group) -> str:
    return group.group_name if isinstance(group, dist.ProcessGroup) else group


def _all_gather(keyset, x: torch.Tensor, group_size: int, group_name) -> torch.Tensor:
    # a group of _C10D_GROUPS: the functional all_gather_into_tensor's
    # contract (dim 0, a new tensor) through c10d's collective, which waits
    # for the result itself; every other group: the functional kernel
    if _group_name(group_name) not in _C10D_GROUPS:
        return _ROUTED[x.device.type][1].call_boxed(keyset, x, group_size, group_name)
    group = group_name if isinstance(group_name, dist.ProcessGroup) else \
        dist.distributed_c10d._resolve_process_group(group_name)
    out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def c10d_all_gathers(mesh) -> None:
    """Send the functional all-gathers of ``mesh``'s process groups through
    c10d's collective.  A kernel of ``_c10d_functional::all_gather_into_tensor``
    for the mesh's device type, installed once, picks the route by group:
    the groups of every other mesh keep the functional kernel."""
    dev = mesh.device_type
    if dev not in _ROUTED:
        functional = torch.library.get_kernel(_AG, dev.upper())
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _all_gather, dev.upper(), with_keyset=True)
        _ROUTED[dev] = (lib, functional)
    _C10D_GROUPS.update(_group_name(mesh.get_group(i)) for i in range(mesh.ndim))


def collective_route(mesh) -> str:
    """The route of ``mesh``'s all-gathers: a gloo group on the card takes
    c10d's collective (:func:`c10d_all_gathers`: DTensor's functional
    all-gather kills a gloo rank on CUDA tensors), every other group the
    functional one.  Returns ``"c10d all_gather_into_tensor"`` or
    ``"functional all_gather_into_tensor"``, the route now in force for
    the mesh."""
    if mesh.device_type == "cuda" and dist.get_backend(mesh.get_group(0)) == "gloo":
        c10d_all_gathers(mesh)
    groups = {_group_name(mesh.get_group(i)) for i in range(mesh.ndim)}
    return ("c10d" if groups <= _C10D_GROUPS else "functional") + " all_gather_into_tensor"


def place(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``t`` as a DTensor with ``sharding``'s placements on its mesh (a
    ``DeviceMesh``; an :class:`AbstractMesh` has no devices).  A plain
    tensor is distributed from rank 0 (every rank passes one of the full
    shape); a DTensor is redistributed."""
    mesh = sharding.mesh
    if isinstance(mesh, AbstractMesh):
        raise ValueError("an AbstractMesh has no devices to place a tensor on")
    collective_route(mesh)
    want = placements(sharding.spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, want)
    return distribute_tensor(t.to(mesh.device_type), mesh, want)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank: a table, a mask, an iota) as a
    replicated DTensor on ``like``'s mesh where ``like`` is a DTensor, else
    ``t`` itself."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


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


def _constrain(x: torch.Tensor, spec: Tuple, mesh, what: str) -> torch.Tensor:
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(spec, mesh))
    if mesh_size(mesh) > 1:
        raise TypeError(f"{what}: a plain tensor of shape {tuple(x.shape)} on a mesh of "
                        f"{mesh_size(mesh)} devices; place the inputs first (place, "
                        "make_global_batch(mesh=))")
    return x


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to its spec under the active rules (the JAX
    package's ``with_sharding_constraint``); identity outside a
    :func:`sharding_ctx`."""
    ctx = get_sharding_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    return _constrain(x, logical_spec(tuple(x.shape), tuple(logical), rules, mesh), mesh, "shard")


def constrain_defs(tree: Any, defs_tree: Any) -> Any:
    """Each tensor of ``tree`` redistributed to the spec its
    :class:`ParamDef` implies; identity outside a :func:`sharding_ctx`.
    The JAX package calls it on each group's weights inside the stacked
    body, which pins the per-layer weight gradients to the parameter
    layout."""
    ctx = get_sharding_ctx()
    if ctx is None:
        return tree
    mesh, rules = ctx
    return tree_map(lambda x, d: _constrain(x, logical_spec(d.shape, d.logical, rules, mesh),
                                            mesh, "constrain_defs"), tree, defs_tree)


# ---------------------------------------------------------------------------
# Local regions: a layer on each rank's local tensors
# ---------------------------------------------------------------------------


def local_view(t: torch.Tensor, want, grad) -> torch.Tensor:
    """The local tensor of DTensor ``t`` redistributed to the placements
    ``want``; its gradient is read with the placements ``grad``
    (``Partial()`` on a mesh dim where each rank holds a part of it)."""
    return t.redistribute(t.device_mesh, tuple(want)).to_local(grad_placements=tuple(grad))


def _no_partial(pl) -> Tuple:
    return tuple(Replicate() if p.is_partial() else p for p in pl)


class _FromParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, local_pl, out_pl):
        ctx.mesh, ctx.grad_pl = mesh, _no_partial(local_pl)
        d = DTensor.from_local(t, mesh, local_pl, run_check=False)
        return d.redistribute(mesh, out_pl)

    @staticmethod
    def backward(ctx, g):
        if not isinstance(g, DTensor):
            raise TypeError("from_parts: a plain gradient for a DTensor output")
        return g.redistribute(ctx.mesh, ctx.grad_pl).to_local(), None, None, None


def from_parts(t: torch.Tensor, mesh, local_pl, out_pl) -> torch.Tensor:
    """A DTensor with placements ``out_pl`` from each rank's local ``t``
    under ``local_pl`` (``Partial()`` where the ranks' tensors sum to the
    value).  The gradient of ``t`` is the output's, replicated over the
    summed dims: each rank's part moves the sum one for one."""
    return _FromParts.apply(t, mesh, tuple(local_pl), tuple(out_pl))


class _PsumLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _psum(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.dims), None, None


def _psum(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    pl = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    d = DTensor.from_local(t, mesh, pl, run_check=False)
    return d.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def psum_local(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``t`` summed over the ranks of the mesh dims ``dims``, locally: the
    sum of each rank's part, used alike by every rank for its own share of
    the work, so that its gradient is a part too and is summed the same
    way."""
    return _PsumLocal.apply(t, mesh, tuple(dims)) if dims else t
