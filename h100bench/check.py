"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each one a gap held to a limit of the cell's.

Training (the first steps of the trainer the window drives):

* ``loss_gap`` — over the checked steps, the largest ``|L - L_ref| / |L_ref|``
  of the loss each step computed;
* ``grad_gap`` — the first gradient as the optimizer got it (clipped), by
  the worst leaf: ``| |g| - |g_ref| |`` over the larger of that leaf's
  ``|g_ref|`` and the median leaf's;
* ``head_grad_gap`` — the same of the first gradient before clipping, over
  the last layer's leaves alone.  Their gradient needs the forward only (no
  ReLU or argmax of the backward lies before them), so a pre-activation or
  a near-tie within rounding, which moves an earlier leaf of a hub row and,
  through global-norm clipping, every clipped leaf, leaves it steady;
* ``change_gap`` — the same as ``grad_gap`` of each leaf's change over the
  checked steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under AdamW by round-off
  alone).

Inference: ``logits_gap`` — over the forwards compared, the largest
``|logit - logit_ref|`` over the largest ``|logit_ref|`` of that forward.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's takes no part in change_gap
STILL_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _gaps(got: Sequence[float], want: Sequence[float]) -> List[float]:
    med = statistics.median(want)
    return [abs(g - w) / max(w, med) for g, w in zip(got, want)]


def train_detail(losses: Sequence[float], first_grads: Sequence[torch.Tensor], first_norm: float,
                 params: Sequence[torch.Tensor], ref, params0: Sequence[torch.Tensor],
                 grad_clip: float) -> Dict[str, list]:
    """Each step's loss gap, each leaf's gradient gap clipped (``grad``) and
    not (``raw``), and each leaf's change gap (None for a leaf left out), of
    the program or the control against the reference's ``ref`` (a
    :class:`~h100bench.reference.gnn.TrainTrace`).  ``first_grads`` and
    ``first_norm`` are step 1's unclipped gradient and its global norm;
    ``params0`` the leaves both started from."""
    if len(losses) != len(ref.losses):
        raise ValueError(f"{len(losses)} losses against {len(ref.losses)}")
    loss = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(losses, ref.losses)]
    raw, raw_ref = [_norm(g) for g in first_grads], [_norm(g) for g in ref.first_grads]
    clip = min(1.0, grad_clip / max(first_norm, 1e-9))
    clip_ref = min(1.0, grad_clip / max(ref.first_norm, 1e-9))
    dev = ref.params[0].device
    change = [_norm(p.to(dev).double() - p0.to(dev).double()) for p, p0 in zip(params, params0)]
    change_ref = [_norm(p.double() - p0.to(dev).double()) for p, p0 in zip(ref.params, params0)]
    g_med = statistics.median(raw_ref)
    return {
        "loss": loss,
        "grad": _gaps([g * clip for g in raw], [g * clip_ref for g in raw_ref]),
        "raw": _gaps(raw, raw_ref),
        "change": [c if g >= STILL_LEAF * g_med else None
                   for c, g in zip(_gaps(change, change_ref), raw_ref)],
    }


def train_numbers(d: Dict[str, list], head: int) -> Dict[str, float]:
    """The numbers of a :func:`train_detail` whose last ``head`` leaves are
    the last layer's."""
    return {"loss_gap": max(d["loss"]), "grad_gap": max(d["grad"]),
            "head_grad_gap": max(d["raw"][-head:]),
            "change_gap": max([c for c in d["change"] if c is not None], default=0.0)}


def logits_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|`` (NaN anywhere in ``got`` reads inf)."""
    diff = (got.to(want.device).double() - want.double()).abs()
    if bool(torch.isnan(diff).any()):
        return math.inf
    return float(diff.max()) / max(float(want.abs().max()), 1e-30)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit, in the limits' order."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no reading for {sorted(missing)}")
    return {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}


def passes(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def flat(tree) -> List[torch.Tensor]:
    """The tensors of nested lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for part in tree for t in flat(part)]
