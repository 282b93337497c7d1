"""AdamW with optional 8-bit quantized moments.

The counterpart of the JAX package's ``repro.optim.adamw``: linear warmup
then cosine decay to 10 % of the peak rate, global-norm gradient
clipping, decoupled weight decay, and moments kept in float32 or as int8
with one f32 absmax scale per trailing row (:class:`QTensor`).  The
update is written out on tensors, not through ``torch.optim.AdamW`` and a
scheduler, so both packages take the same step: the same operations in
the same order, in float32.  ``torch.round`` and ``jnp.round`` both round
half to even, so int8 moments quantize alike.

Parameters and moments are trees of tensors: lists, tuples (named tuples
included, such as the GNN layers' parameter tuples) and dicts, flattened
in the JAX package's order (sequences in order, dict keys sorted).
:func:`load_opt_state` carries an optimizer state across from the JAX
package (numpy ``m``, ``v`` and ``step``, int8 moments included).

A layer-stacked giant (a leaf with ``ndim >= 2`` and more than
``_SCAN_LIMIT`` elements, such as an LM's ``[n_layers, d, d_ff]`` FFN
stack) is updated one slice of axis 0 at a time, as the JAX package's
``lax.map`` does, so the f32 update chain's transients stay one layer's
size; the result is bit for bit the whole-leaf update's.

:func:`opt_state_specs` gives the moments' specs over a mesh: they inherit
the parameter specs, so the optimizer state is sharded exactly like the
FSDP weights.  On a mesh the leaves are DTensors and the update runs on
each rank's shards: the global gradient norm sums every shard (one
all-reduce of a scalar), an int8 moment's per-row scale is the absmax of
the global row (an all-reduce of the row maxima where the last dim is
sharded), and the scale is left replicated over the axes of that dim, as
its spec says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = [
    "AdamWConfig",
    "QTensor",
    "lr_schedule",
    "init_opt_state",
    "adamw_update",
    "load_opt_state",
    "opt_state_specs",
    "tree_flatten",
    "tree_leaves",
    "update_per_layer",
]

# Leaves above this many elements (and with ndim >= 2) take the per-layer
# update of update_per_layer.
_SCAN_LIMIT = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | int8


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = ((step - cfg.warmup_steps) / max(cfg.decay_steps, 1)).clamp(0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr_peak * torch.minimum(warm, cos)


# --- int8 quantization -----------------------------------------------------
# Moments keep the parameter's shape (int8) with one f32 absmax scale per
# trailing row.


class QTensor(NamedTuple):
    q: torch.Tensor  # int8, parameter shape
    scale: torch.Tensor  # f32, shape[:-1] + (1,)


def _quantize(x: torch.Tensor) -> QTensor:
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    if isinstance(x, DTensor):  # the spec of the scale: the last dim unsharded
        last = x.dim() - 1
        scale = scale.redistribute(x.device_mesh, [
            Replicate() if p.is_shard(last) else p for p in x.placements])
    scale = scale.clamp(min=1e-12)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale.to(torch.float32))


def _dequantize(t: QTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale


def _wrap(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(torch.float32)


def _unwrap(m) -> torch.Tensor:
    return _dequantize(m) if isinstance(m, QTensor) else m


# --- trees -----------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, QTensor)) or not isinstance(x, (list, tuple, dict))


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves in the JAX package's order and a function that rebuilds the
    tree from a list of new leaves."""
    if _is_leaf(tree):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[key]) for key in keys]
    else:
        keys = None
        parts = [tree_flatten(v) for v in tree]
    sizes = [len(leaves) for leaves, _ in parts]
    leaves = [leaf for part, _ in parts for leaf in part]

    def rebuild(new):
        out, i = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(new[i : i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)

    return leaves, rebuild


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of tensors, in the JAX package's order."""
    return tree_flatten(tree)[0]


def _tree_map(fn, tree):
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(leaf) for leaf in leaves])


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` and step 0."""
    def zeros(p):
        return _wrap(torch.zeros_like(p, dtype=torch.float32), cfg.state_dtype)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "m": _tree_map(zeros, params),
        "v": _tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_specs(params_abs, param_specs, cfg: AdamWConfig, mesh=None) -> Dict[str, Any]:
    """The moments' specs (tuples, as :func:`repro_torch.models.params.logical_spec`
    gives) for a dict tree of parameters and their specs.  f32 moments
    mirror the parameter specs; int8 moments keep the parameter's shape, so
    ``q`` reuses its spec and the per-row ``scale`` drops the last dim."""

    def mom(p, spec):
        if cfg.state_dtype != "int8":
            return spec
        entries = tuple(spec) + (None,) * (p.dim() - len(spec))
        return QTensor(entries, entries[:-1] + (None,))

    def zip_map(p, s):
        if isinstance(p, dict):
            return {k: zip_map(p[k], s[k]) for k in p}
        return mom(p, s)

    return {"m": zip_map(params_abs, param_specs), "v": zip_map(params_abs, param_specs),
            "step": ()}


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))


def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step.  Returns ``(new_params, new_opt_state, metrics)``."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    flat_p, rebuild = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_flatten(opt_state["m"])[0]
    flat_v = tree_flatten(opt_state["v"])[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments must have the same structure")
    gnorm = _global_norm(flat_g)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def update_leaf(p, g, m, v):
        g32 = g.to(torch.float32) * clip
        m32 = _unwrap(m) * b1 + (1 - b1) * g32
        v32 = _unwrap(v) * b2 + (1 - b2) * g32 * g32
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.to(torch.float32) * (1.0 - lr * cfg.weight_decay) - lr * upd
        return p32.to(p.dtype), _wrap(m32, cfg.state_dtype), _wrap(v32, cfg.state_dtype)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if p.ndim >= 2 and p.numel() > _SCAN_LIMIT:
            np_, nm, nv = update_per_layer(update_leaf, p, g, m, v)
        else:
            np_, nm, nv = update_leaf(p, g, m, v)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)

    metrics = {"lr": lr, "grad_norm": gnorm, "step": step}
    return (
        rebuild(new_p),
        {"m": rebuild(new_m), "v": rebuild(new_v), "step": step},
        metrics,
    )


def _row(m, i: int):
    return QTensor(m.q[i], m.scale[i]) if isinstance(m, QTensor) else m[i]


def _empty_like(m):
    if isinstance(m, QTensor):
        return QTensor(torch.empty_like(m.q), torch.empty_like(m.scale))
    return torch.empty_like(m, dtype=torch.float32)


def _put(out, i: int, value) -> None:
    if isinstance(out, QTensor):
        out.q[i] = value.q
        out.scale[i] = value.scale
    else:
        out[i] = value


def update_per_layer(update_leaf, p, g, m, v):
    """``update_leaf`` (one leaf's AdamW step) over the slices of axis 0,
    written into new tensors; adds one to ``update_per_layer.leaves``."""
    out_p, out_m, out_v = torch.empty_like(p), _empty_like(m), _empty_like(v)
    for i in range(p.shape[0]):
        pi, mi, vi = update_leaf(p[i], g[i], _row(m, i), _row(v, i))
        out_p[i] = pi
        _put(out_m, i, mi)
        _put(out_v, i, vi)
    update_per_layer.leaves += 1
    return out_p, out_m, out_v


update_per_layer.leaves = 0


def load_opt_state(opt_state, device=None) -> Dict[str, Any]:
    """An optimizer state carried across from the JAX package.

    ``opt_state`` is ``{"m": ..., "v": ..., "step": ...}`` whose moment
    trees mirror the parameters' (one tuple per layer in field order, for
    the GNN stacks), with numpy or array-like leaves; an int8 moment is
    any pair with ``q`` and ``scale`` fields (the JAX package's
    ``QTensor``).  Returns the same state as tensors on ``device``.
    """
    def moment(tree):
        if hasattr(tree, "q") and hasattr(tree, "scale"):
            return QTensor(
                torch.as_tensor(np.array(tree.q), dtype=torch.int8, device=device),
                torch.as_tensor(np.array(tree.scale), dtype=torch.float32, device=device),
            )
        if isinstance(tree, dict):
            return {key: moment(value) for key, value in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [moment(value) for value in tree]
        return torch.as_tensor(np.array(tree), dtype=torch.float32, device=device)

    return {
        "m": moment(opt_state["m"]),
        "v": moment(opt_state["v"]),
        "step": torch.as_tensor(np.array(opt_state["step"]), dtype=torch.int32,
                                device=device).reshape(()),
    }
