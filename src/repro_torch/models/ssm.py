"""Mamba-2 blocks via the SSD (state-space duality) chunked algorithm.

Training/prefill uses the chunked-quadratic SSD form: within chunks of
``cfg.ssm_chunk`` tokens the recurrence is a masked-decay product; across
chunks a loop carries the ``[heads, state, head_dim]`` recurrent state
(the JAX package's ``lax.scan``).  Decode is the O(1) recurrent step.

Layer structure follows Mamba-2: fused input projection into
(x, z, B, C, dt), a short causal depthwise conv over [x;B;C], SSD, gated
RMSNorm, output projection.  The conv and the scan run in float32 (in
float64 in a float64 model, as the attention scores do).  The decode
cache (conv history, state) is written in place.

On a mesh (a DTensor ``x`` inside a sharding context) the training block
runs on each rank's rows and inner channels (:func:`_mamba_mesh`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig

from .layers import rmsnorm, wide
from .params import (
    ParamDef,
    dtype_of,
    from_parts,
    get_sharding_ctx,
    local_view,
    psum_local,
    shard,
)

__all__ = ["mamba_defs", "mamba_apply", "init_mamba_cache", "ssd_chunked", "MAMBA_CACHE_LOGICAL"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    d = cfg.d_model
    di = cfg.ssm_inner
    n = cfg.ssm_state
    hp = cfg.ssm_head_dim
    nh = di // hp
    return d, di, n, hp, nh


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, n, hp, nh = _dims(cfg)
    ch = di + 2 * n  # conv runs over [x; B; C]
    return {
        "wx": ParamDef((d, di), ("embed", "ssm_inner")),
        "wz": ParamDef((d, di), ("embed", "ssm_inner")),
        "wB": ParamDef((d, n), ("embed", None)),
        "wC": ParamDef((d, n), ("embed", None)),
        "wdt": ParamDef((d, nh), ("embed", "ssm_heads")),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="const:-4.6"),  # softplus^-1(0.01)
        "A_log": ParamDef((nh,), ("ssm_heads",), init="a_log"),
        "D": ParamDef((nh,), ("ssm_heads",), init="ones"),
        "conv_w": ParamDef((cfg.ssm_conv, ch), (None, "ssm_conv_ch"), scale=0.5),
        "conv_b": ParamDef((ch,), ("ssm_conv_ch",), init="zeros"),
        "norm_w": ParamDef((di,), ("ssm_inner",), init="ones"),
        "wout": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, device, lead=()):
    """Zeroed decode cache (``lead``: leading stack dims)."""
    d, di, n, hp, nh = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype_of(cfg),
                            device=device),
        "state": torch.zeros(lead + (batch, nh, n, hp), dtype=torch.float32, device=device),
    }


# logical axes of the decode cache's leaves (for their specs)
MAMBA_CACHE_LOGICAL = {
    "conv": ("cache_batch", None, "ssm_conv_ch"),
    "state": ("cache_batch", "ssm_heads", None, None),
}


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor]):
    """Depthwise causal conv, kernel K small (4): sum of shifted slices.

    ``history`` is the last K-1 inputs from a previous segment (decode/
    prefill continuation) or None (zero history)."""
    B, S, CH = xBC.shape
    K = w.shape[0]
    if history is None:
        history = xBC.new_zeros(B, K - 1, CH)
    padded = torch.cat([history.to(xBC.dtype), xBC], dim=1)
    terms = [wide(padded[:, k : k + S, :]) * wide(w[k]) for k in range(K)]
    out = sum(terms[1:], terms[0]) + wide(b)
    new_history = padded[:, -(K - 1):, :] if K > 1 else history
    return F.silu(out).to(xBC.dtype), new_history


def ssd_chunked(
    x: torch.Tensor,  # [B, S, nh, hp]
    dt: torch.Tensor,  # [B, S, nh]  (post-softplus, > 0)
    A: torch.Tensor,  # [nh]  (< 0)
    Bm: torch.Tensor,  # [B, S, n]
    Cm: torch.Tensor,  # [B, S, n]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, nh, n, hp]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y [B,S,nh,hp] f32, f64 for float64
    inputs; final_state)."""
    B, S, nh, hp = x.shape
    n = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q
    xc = wide(x.reshape(B, nc, Q, nh, hp))
    dtc = wide(dt.reshape(B, nc, Q, nh))
    Bc = wide(Bm.reshape(B, nc, Q, n))
    Cc = wide(Cm.reshape(B, nc, Q, n))

    a = dtc * A  # [B,nc,Q,nh], negative log-decay increments
    a_cs = torch.cumsum(a, dim=2)

    # --- intra-chunk (quadratic within Q)
    diff = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]  # [B,nc,Q,Q,nh]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp, not after (the JAX package's form): at long
    # chunks the upper triangle's exp overflows, and the gradient of
    # where(tri, exp(diff), 0) there is 0 * inf = NaN; the same values
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff, float("-inf")))
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    M = G[..., None] * L
    y_diag = torch.einsum("bcqkh,bckh,bckhp->bcqhp", M, dtc, xc)

    # --- chunk boundary states
    a_sum = a_cs[:, :, -1, :]  # [B,nc,nh]
    decay_out = torch.exp(a_sum[:, :, None, :] - a_cs)  # [B,nc,Q,nh]
    S_c = torch.einsum("bckn,bckh,bckhp->bchnp", Bc, decay_out * dtc, xc)

    # --- inter-chunk recurrence (the JAX package's lax.scan over chunks)
    S_prev = (
        init_state.to(xc.dtype)
        if init_state is not None
        else torch.zeros((B, nh, n, hp), dtype=xc.dtype, device=x.device)
    )
    prevs = []
    for c in range(nc):
        prevs.append(S_prev)
        S_prev = S_prev * torch.exp(a_sum[:, c])[:, :, None, None] + S_c[:, c]
    S_prevs = torch.stack(prevs, dim=1)  # [B,nc,nh,n,hp]

    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, S_prevs, torch.exp(a_cs))
    y = (y_diag + y_off).reshape(B, Sp, nh, hp)[:, :S]
    return y, S_prev


def mamba_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba-2 block.  [B,S,D] -> [B,S,D]; decode when S == 1 and cache.
    Returns ``(y, cache)``: the cache given, written in place."""
    if isinstance(x, DTensor):
        if cache is not None:
            raise ValueError("mamba_apply: a decode cache on a mesh is not supported")
        return _mamba_mesh(p, x, cfg), None
    return _mamba_body(p, x, cfg, cache)


def _mamba_body(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Dict],
                mean_sq=None):
    """The block on ``p``'s inner channels and heads (all of them on one
    device; a rank's own on a mesh); ``mean_sq`` reduces the gated norm's
    squares over ``d_inner`` (default: over the tensor's last dim)."""
    B, S, _ = x.shape
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    di, nh = p["wx"].shape[1], p["wdt"].shape[1]
    A = -torch.exp(wide(p["A_log"]))  # [nh]

    xi = x @ p["wx"]
    z = x @ p["wz"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus(wide(x @ p["wdt"]) + wide(p["dt_bias"]))
    xBC = torch.cat([xi, Bm.to(xi.dtype), Cm.to(xi.dtype)], dim=-1)

    history = cache["conv"] if cache is not None else None
    conv_out, new_history = _causal_conv(xBC, p["conv_w"], p["conv_b"], history)
    xc, Bc, Cc = conv_out[..., :di], conv_out[..., di : di + n], conv_out[..., di + n :]
    xh = xc.reshape(B, S, nh, hp)

    if cache is not None and S == 1:
        # O(1) recurrent decode step
        dt1 = dt[:, 0]  # [B,nh]
        decay = torch.exp(dt1 * A)  # [B,nh]
        upd = torch.einsum("bn,bh,bhp->bhnp", wide(Bc[:, 0]), dt1, wide(xh[:, 0]))
        st = cache["state"] * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", wide(Cc[:, 0]), st)
        y = y + wide(p["D"])[:, None] * wide(xh[:, 0])
        y = y[:, None]  # [B,1,nh,hp]
    else:
        init_state = cache["state"] if cache is not None else None
        y, st = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk, init_state)
        y = y + wide(p["D"])[None, None, :, None] * wide(xh)
    if cache is not None:
        cache["conv"].copy_(new_history)
        cache["state"].copy_(st)

    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], mean_sq=mean_sq)
    return y @ p["wout"], cache


# the leaves split over the inner channels / heads, and the dim they split on
_TP_LEAVES = {"wx": 1, "wz": 1, "wdt": 1, "dt_bias": 0, "A_log": 0, "D": 0, "norm_w": 0,
              "wout": 0}


def _mamba_mesh(p: Dict, x: DTensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`mamba_apply` of a DTensor ``x`` on the active mesh (training).

    Each rank runs the block on its own batch rows, each sequence whole
    (the conv and the chunked scan run along it: under ``TRAIN_RULES_SP``
    the sequence is gathered first, as XLA reshards it for the JAX
    package), and on its own inner channels and heads, those its
    ``ssm_inner``/``ssm_heads`` leaves hold (the heads must split as the
    channels do).  ``B`` and ``C`` are computed whole on every rank.  The
    conv's channels ``[x; B; C]`` are sharded evenly over ``ssm_conv_ch``,
    which does not line up with ``x``'s: the conv weights are gathered
    and each rank takes its ``x`` channels and the ``B``/``C`` ones.  The
    gated RMSNorm reduces over ``d_inner``: its sum of squares is summed
    over the inner channels' mesh dims.  The output projection's parts are
    summed over them too."""
    ctx = get_sharding_ctx()
    if ctx is None:
        raise ValueError("mamba_apply of a DTensor runs inside a sharding_ctx")
    mesh = ctx[0]
    di, n = cfg.ssm_inner, cfg.ssm_state
    xr = shard(x, "batch", None, None)  # the rows over the batch's axes, each sequence whole
    batch = [i for i, pl in enumerate(xr.placements) if pl.is_shard(0)]
    tp = [i for i, pl in enumerate(p["wx"].placements) if pl.is_shard(1)]
    for name, dim in _TP_LEAVES.items():
        got = [i for i, pl in enumerate(p[name].placements) if pl.is_shard(dim)]
        if got != tp:
            raise ValueError(f"mamba_apply: {name} sharded over mesh dims {got}, wx's inner "
                             f"channels over {tp}: the heads must split as the channels do")
    if len(tp) > 1 or set(tp) & set(batch) or any(
            not (pl.is_shard(0) or pl.is_replicate()) for pl in xr.placements):
        raise ValueError(f"mamba_apply: rows placed as {xr.placements}, the inner channels "
                         f"over mesh dims {tp}")
    dims = range(mesh.ndim)
    summed = [Partial() if (i in batch or i in tp) else Replicate() for i in dims]
    local = {}
    for name, dim in _TP_LEAVES.items():
        local[name] = local_view(
            p[name], [Shard(dim) if i in tp else Replicate() for i in dims],
            [Shard(dim) if i in tp else Partial() if i in batch else Replicate() for i in dims])
    for name in ("wB", "wC", "conv_w", "conv_b"):
        local[name] = local_view(p[name], [Replicate()] * mesh.ndim, summed)
    lo, hi = 0, di
    if tp:
        width = di // mesh.size(tp[0])
        lo = mesh.get_local_rank(tp[0]) * width
        hi = lo + width
    for name in ("conv_w", "conv_b"):  # this rank's x channels, then B and C
        w = local[name]
        local[name] = torch.cat([w[..., lo:hi], w[..., di:di + 2 * n]], dim=-1)

    def mean_sq(v):
        return psum_local(torch.sum(v * v, dim=-1, keepdim=True), mesh, tp) / di

    x_l = local_view(xr, xr.placements, [Partial() if i in tp else pl
                                          for i, pl in enumerate(xr.placements)])
    out, _ = _mamba_body(local, x_l, cfg, None, mean_sq)
    return from_parts(out, mesh, [Partial() if i in tp else pl
                                  for i, pl in enumerate(xr.placements)], x.placements)
