"""Training step factory: loss, microbatch gradient accumulation, AdamW.

The JAX package's ``repro.train.steps`` on PyTorch tensors:

* next-token cross-entropy (f32 logits) + MoE load-balance aux loss;
* optional gradient accumulation: the global batch is split into
  ``n_microbatch`` slices, and the gradients accumulate in ``acc_dtype``
  (f32) as ``acc + g / n``, slice by slice, in the JAX package's order;
  with more than one slice the reported ``aux`` is 0, as there;
* remat (``torch.utils.checkpoint``) on the stacked layers via
  ``remat=True`` (:func:`repro_torch.models.transformer.stack_apply`);
* AdamW with optional int8 moments (:mod:`repro_torch.optim.adamw`).

Gradients come from ``torch.autograd.grad`` with respect to detached
copies of the parameter leaves, so the train state stays a plain dict of
tensors with no autograd history, mirroring the JAX package's pytree.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import wide
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state, tree_flatten

__all__ = ["loss_fn", "make_train_step", "init_train_state"]

AUX_WEIGHT = 0.01


def loss_fn(model: Model, params, batch: Dict[str, torch.Tensor], *, remat: bool = False):
    """Mean next-token CE over the batch (+ MoE aux).

    The JAX package takes the target logit as a masked sum over the vocab
    dim (its vocab dim is sharded over a mesh); on one card a gather gives
    the same value (one logit plus zeros)."""
    logits, _, aux = model.forward(params, batch, remat=remat)
    tokens = batch["tokens"]
    logits = wide(logits[:, :-1])
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = torch.mean(lse - tgt_logit)
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def init_train_state(model: Model, generator: torch.Generator, opt_cfg: AdamWConfig,
                     device=None):
    """Parameters from ``generator`` and zero moments, on ``device``
    (default: the card)."""
    params = model.init(generator, device=device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _split_micro(batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    n_microbatch: int = 1,
    remat: bool = True,
    acc_dtype=torch.float32,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    metrics are tensors on the state's device (reading one syncs)."""

    def grads_of(params, batch):
        leaves, rebuild = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss, parts = loss_fn(model, rebuild(live), batch, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads, rebuild

    def train_step(state, batch):
        params = state["params"]
        if n_microbatch == 1:
            loss, parts, grads, rebuild = grads_of(params, batch)
        else:
            micro = _split_micro(batch, n_microbatch)
            acc = None
            losses, ces = [], []
            for i in range(n_microbatch):
                loss, parts, g, rebuild = grads_of(params, {k: v[i] for k, v in micro.items()})
                if acc is None:
                    acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in g]
                for a, gg in zip(acc, g):
                    a.add_(gg.to(acc_dtype) / n_microbatch)
                del g
                losses.append(loss)
                ces.append(parts["ce"])
            grads = acc
            loss = torch.stack(losses).mean()
            parts = {"ce": torch.stack(ces).mean(), "aux": torch.zeros((), device=loss.device)}
        new_params, new_opt, om = adamw_update(params, rebuild(grads), state["opt"], opt_cfg)
        metrics = {"loss": loss, **parts, **om}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
