"""Layer assembly: blocks, stacks, caches.

Layers are grouped into the smallest repeating pattern
(``cfg.layer_period``: 1 for uniform stacks, 8 for Jamba's 1:7
mamba/attention interleave) and the stack's parameters are stacked along
a leading group dimension, ``[n_groups, ...]``, as in the JAX package, so
that its weights carry over 1:1.  Where the JAX package scans over the
groups, a loop here walks the groups of every stacked leaf, unbound once
per call (``torch.unbind``: one ``stack`` of the gradients in the
backward, where indexing group by group would add a zero-filled copy of
the whole stack per group).  ``moe_first_dense`` layers (DeepSeek-V2) run
as a prologue before the stack.

``remat=True`` recomputes activations in the backward pass as the JAX
package's ``jax.checkpoint`` does, and only where it does: on the stacked
(``scan_layers``) groups, never on the prologue.  Each group runs under
``torch.utils.checkpoint``; with no cache and ``n_inner =
_sqrt_factor(n_groups) > 1``, runs of ``n_inner`` groups run under an
outer checkpoint as well (the two-level split: the forward keeps only
``n_groups / n_inner`` boundary activations).

Decode caches mirror the stack structure: per-layer cache dicts, stacked
along the same leading group dimension.  Group ``g``'s cache is a view
into the stacked tensors, so a layer's in-place cache writes land in the
stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

from .attention import ATTN_CACHE_LOGICAL, attention_apply, attention_defs, init_attn_cache
from .layers import apply_norm, grad_dtype_guard, mlp_apply, mlp_defs, norm_defs
from .moe import moe_apply, moe_defs
from .params import dtype_of, stack_defs, tree_map
from .ssm import MAMBA_CACHE_LOGICAL, init_mamba_cache, mamba_apply, mamba_defs

__all__ = [
    "LogicalAxes",
    "block_defs",
    "block_apply",
    "stack_defs_for",
    "stack_apply",
    "init_stack_cache",
    "stack_cache_logical",
]


@dataclasses.dataclass(frozen=True)
class LogicalAxes:
    """Leaf marker carrying the logical axis names of a non-parameter
    tensor (a decode cache's)."""

    axes: Tuple[Optional[str], ...]


def _sqrt_factor(n: int) -> int:
    """Largest divisor of n not exceeding sqrt(n) (two-level remat split)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best


def block_defs(cfg: ModelConfig, kind: Tuple[str, str], *, cross: bool = False) -> Dict:
    mixer, ffn = kind
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg)}
    if mixer == "attn":
        defs["attn"] = attention_defs(cfg)
    else:
        defs["mamba"] = mamba_defs(cfg)
    if cross:
        defs["norm_cross"] = norm_defs(cfg)
        defs["cross"] = attention_defs(cfg, cross=True)
    if ffn == "dense":
        defs["norm2"] = norm_defs(cfg)
        ff = cfg.first_dense_ff if (cfg.moe_experts and cfg.first_dense_ff) else None
        defs["ffn"] = mlp_defs(cfg, d_ff=ff)
    elif ffn == "moe":
        defs["norm2"] = norm_defs(cfg)
        defs["moe"] = moe_defs(cfg)
    return defs


def block_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: Tuple[str, str],
    *,
    pos0: int = 0,
    cache: Optional[Dict] = None,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block.  Returns (x, aux_loss); ``cache`` (this
    block's) is written in place."""
    mixer, ffn = kind
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    h = apply_norm(p["norm1"], x, cfg)
    if mixer == "attn":
        mx, _ = attention_apply(
            p["attn"], h, cfg, pos0=pos0,
            cache=None if cache is None else cache.get("attn"), causal=causal,
        )
    else:
        mx, _ = mamba_apply(p["mamba"], h, cfg, cache=None if cache is None else cache.get("mamba"))
    x = x + mx

    if enc_out is not None or (cache is not None and "cross" in cache):
        h = apply_norm(p["norm_cross"], x, cfg)
        cx, _ = attention_apply(
            p["cross"], h, cfg, pos0=pos0, kv_x=enc_out, cross=True,
            cache=None if cache is None else cache.get("cross"), causal=False,
        )
        x = x + cx

    if ffn != "none":
        h = apply_norm(p["norm2"], x, cfg)
        if ffn == "dense":
            f = mlp_apply(p["ffn"], h, cfg)
        else:
            f, aux = moe_apply(p["moe"], h, cfg)
        x = x + f
    return grad_dtype_guard(x), aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _pattern(cfg: ModelConfig, n_layers: int):
    """(prologue kinds, period kinds, n_groups) for a decoder stack."""
    prologue = cfg.moe_first_dense if cfg.moe_experts else 0
    period = cfg.layer_period
    body = n_layers - prologue
    if body % period:
        raise ValueError(f"{n_layers} layers less a prologue of {prologue} do not "
                         f"divide into periods of {period}")
    prologue_kinds = [cfg.layer_kind(l) for l in range(prologue)]
    period_kinds = [cfg.layer_kind(prologue + j) for j in range(period)]
    return prologue_kinds, period_kinds, body // period


def stack_defs_for(cfg: ModelConfig, *, n_layers: int, cross: bool = False) -> Dict:
    prologue_kinds, period_kinds, n_groups = _pattern(cfg, n_layers)
    defs: Dict[str, Any] = {}
    for i, kind in enumerate(prologue_kinds):
        defs[f"pro{i}"] = block_defs(cfg, kind, cross=cross)
    group = {f"l{j}": block_defs(cfg, kind, cross=cross) for j, kind in enumerate(period_kinds)}
    if cfg.scan_layers:
        defs["stack"] = stack_defs(group, n_groups)
    else:
        for g in range(n_groups):
            defs[f"g{g}"] = group  # shared structure, distinct leaves on init
    return defs


def stack_apply(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    n_layers: int,
    pos0: int = 0,
    cache: Optional[Dict] = None,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stack; returns (x, aux_loss) and writes ``cache`` in place."""
    prologue_kinds, period_kinds, n_groups = _pattern(cfg, n_layers)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(p, x, c, kind):
        return block_apply(p, x, cfg, kind, pos0=pos0, cache=c, enc_out=enc_out, causal=causal)

    for i, kind in enumerate(prologue_kinds):
        x, aux = run(params[f"pro{i}"], x, None if cache is None else cache[f"pro{i}"], kind)
        aux_total = aux_total + aux

    def group_apply(gp, x, gcache):
        gaux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(period_kinds):
            x, aux = run(gp[f"l{j}"], x, None if gcache is None else gcache[f"l{j}"], kind)
            gaux = gaux + aux
        return x, gaux

    if not cfg.scan_layers:
        for g in range(n_groups):
            x, gaux = group_apply(params[f"g{g}"], x, None if cache is None else cache[f"g{g}"])
            aux_total = aux_total + gaux
        return x, aux_total

    groups = _unbind(params["stack"], n_groups)
    # a cache is written in place, through single views (an unbind's
    # outputs may not be written in place under autograd)
    gcaches = [None if cache is None else tree_map(lambda a: a[g], cache["stack"])
               for g in range(n_groups)]
    body = group_apply
    if remat:
        def body(gp, x, gcache):
            return checkpoint(group_apply, gp, x, gcache, use_reentrant=False,
                              preserve_rng_state=False)

    n_inner = _sqrt_factor(n_groups) if (remat and cache is None) else 1
    gauxs = []
    if n_inner > 1:
        def outer(run_groups, x):
            inner = []
            for gp in run_groups:
                x, gaux = body(gp, x, None)
                inner.append(gaux)
            return x, torch.stack(inner)

        for o in range(0, n_groups, n_inner):
            x, inner = checkpoint(outer, groups[o : o + n_inner], x, use_reentrant=False,
                                  preserve_rng_state=False)
            gauxs.append(inner)
    else:
        for gp, gcache in zip(groups, gcaches):
            x, gaux = body(gp, x, gcache)
            gauxs.append(gaux[None])
    return x, aux_total + torch.cat(gauxs).sum()


def _unbind(stacked, n: int):
    """The ``n`` groups of a tree of stacked leaves, as views."""
    parts = tree_map(lambda a: torch.unbind(a, 0), stacked)
    return [tree_map(lambda t: t[g], parts) for g in range(n)]


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _block_cache(cfg, kind, batch, max_len, device, *, cross_len: int = 0, lead=()):
    mixer, _ = kind
    c: Dict[str, Any] = {}
    if mixer == "attn":
        c["attn"] = init_attn_cache(cfg, batch, max_len, device, lead)
    else:
        c["mamba"] = init_mamba_cache(cfg, batch, device, lead)
    if cross_len:
        hd = cfg.resolved_head_dim
        shape = lead + (batch, cross_len, cfg.n_kv_heads, hd)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                      "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
    return c


def init_stack_cache(cfg: ModelConfig, *, n_layers: int, batch: int, max_len: int,
                     device, cross_len: int = 0):
    """Zeroed decode cache for a stack on ``device``."""
    prologue_kinds, period_kinds, n_groups = _pattern(cfg, n_layers)
    cache: Dict[str, Any] = {}
    for i, kind in enumerate(prologue_kinds):
        cache[f"pro{i}"] = _block_cache(cfg, kind, batch, max_len, device, cross_len=cross_len)
    if cfg.scan_layers:
        cache["stack"] = {
            f"l{j}": _block_cache(cfg, kind, batch, max_len, device, cross_len=cross_len,
                                  lead=(n_groups,))
            for j, kind in enumerate(period_kinds)
        }
    else:
        for g in range(n_groups):
            cache[f"g{g}"] = {
                f"l{j}": _block_cache(cfg, kind, batch, max_len, device, cross_len=cross_len)
                for j, kind in enumerate(period_kinds)
            }
    return cache


def _block_cache_logical(cfg, kind, *, cross: bool = False):
    mixer, _ = kind
    c: Dict[str, Any] = {}
    if mixer == "attn":
        keys = ("ckv", "kpe") if cfg.mla_kv_lora else ("k", "v")
        c["attn"] = {k: LogicalAxes(ATTN_CACHE_LOGICAL[k]) for k in keys}
    else:
        c["mamba"] = {k: LogicalAxes(MAMBA_CACHE_LOGICAL[k]) for k in ("conv", "state")}
    if cross:
        c["cross"] = {k: LogicalAxes(ATTN_CACHE_LOGICAL[k]) for k in ("k", "v")}
    return c


def stack_cache_logical(cfg: ModelConfig, *, n_layers: int, cross: bool = False):
    """The structure of :func:`init_stack_cache` with :class:`LogicalAxes`
    leaves (for the cache's specs)."""
    prologue_kinds, period_kinds, n_groups = _pattern(cfg, n_layers)
    tree: Dict[str, Any] = {}
    for i, kind in enumerate(prologue_kinds):
        tree[f"pro{i}"] = _block_cache_logical(cfg, kind, cross=cross)
    group = {f"l{j}": _block_cache_logical(cfg, kind, cross=cross)
             for j, kind in enumerate(period_kinds)}
    if cfg.scan_layers:
        tree["stack"] = tree_map(lambda l: LogicalAxes(("layers",) + l.axes), group)
    else:
        for g in range(n_groups):
            tree[f"g{g}"] = group
    return tree
