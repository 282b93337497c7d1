"""Mamba-2 blocks via the SSD (state-space duality) chunked algorithm.

Training/prefill uses the chunked-quadratic SSD form: within chunks of
``cfg.ssm_chunk`` tokens the recurrence is a masked-decay product; across
chunks a loop carries the ``[heads, state, head_dim]`` recurrent state
(the JAX package's ``lax.scan``).  Decode is the O(1) recurrent step.

Layer structure follows Mamba-2: fused input projection into
(x, z, B, C, dt), a short causal depthwise conv over [x;B;C], SSD, gated
RMSNorm, output projection.  The decode cache (conv history, state) is
written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import rmsnorm
from .params import ParamDef, dtype_of

__all__ = ["mamba_defs", "mamba_apply", "init_mamba_cache", "ssd_chunked"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
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
    terms = [padded[:, k : k + S, :].float() * w[k].float() for k in range(K)]
    out = sum(terms[1:], terms[0]) + b.float()
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
    """Chunked SSD scan.  Returns (y [B,S,nh,hp] f32, final_state)."""
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
    xc = x.reshape(B, nc, Q, nh, hp).float()
    dtc = dt.reshape(B, nc, Q, nh).float()
    Bc = Bm.reshape(B, nc, Q, n).float()
    Cc = Cm.reshape(B, nc, Q, n).float()

    a = dtc * A  # [B,nc,Q,nh], negative log-decay increments
    a_cs = torch.cumsum(a, dim=2)

    # --- intra-chunk (quadratic within Q)
    diff = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]  # [B,nc,Q,Q,nh]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # exp of the upper triangle may overflow; where() drops it
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    M = G[..., None] * L
    y_diag = torch.einsum("bcqkh,bckh,bckhp->bcqhp", M, dtc, xc)

    # --- chunk boundary states
    a_sum = a_cs[:, :, -1, :]  # [B,nc,nh]
    decay_out = torch.exp(a_sum[:, :, None, :] - a_cs)  # [B,nc,Q,nh]
    S_c = torch.einsum("bckn,bckh,bckhp->bchnp", Bc, decay_out * dtc, xc)

    # --- inter-chunk recurrence (the JAX package's lax.scan over chunks)
    S_prev = (
        init_state.float()
        if init_state is not None
        else torch.zeros((B, nh, n, hp), dtype=torch.float32, device=x.device)
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
    B, S, _ = x.shape
    d, di, n, hp, nh = _dims(cfg)
    A = -torch.exp(p["A_log"].float())  # [nh]

    xi = x @ p["wx"]
    z = x @ p["wz"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"].float())
    xBC = torch.cat([xi, Bm.to(xi.dtype), Cm.to(xi.dtype)], dim=-1)

    history = cache["conv"] if cache is not None else None
    conv_out, new_history = _causal_conv(xBC, p["conv_w"], p["conv_b"], history)
    xc, Bc, Cc = conv_out[..., :di], conv_out[..., di : di + n], conv_out[..., di + n :]
    xh = xc.reshape(B, S, nh, hp)

    if cache is not None and S == 1:
        # O(1) recurrent decode step
        dt1 = dt[:, 0]  # [B,nh]
        decay = torch.exp(dt1 * A)  # [B,nh]
        upd = torch.einsum("bn,bh,bhp->bhnp", Bc[:, 0].float(), dt1, xh[:, 0].float())
        st = cache["state"] * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), st)
        y = y + p["D"].float()[:, None] * xh[:, 0].float()
        y = y[:, None]  # [B,1,nh,hp]
    else:
        init_state = cache["state"] if cache is not None else None
        y, st = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk, init_state)
        y = y + p["D"].float()[None, None, :, None] * xh.float()
    if cache is not None:
        cache["conv"].copy_(new_history)
        cache["state"].copy_(st)

    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    return y @ p["wout"], cache
