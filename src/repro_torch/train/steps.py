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

``param_shardings`` (a tree of
:class:`~repro_torch.models.params.NamedSharding` mirroring the
parameters) constrains the gradients and the f32 accumulation buffer to
the parameters' placements, as the JAX package's does: on a mesh the
gradients come back ``Partial`` (summed) over ``data``, and the constraint
is their reduce-scatter to the FSDP shards (ZeRO).  On a mesh the state
holds DTensors (:func:`~repro_torch.models.params.place`), the batch
comes from ``make_global_batch(mesh=)`` and the step runs inside a
:func:`~repro_torch.models.params.sharding_ctx`; microbatch ``i`` holds
rows ``[i b / n, (i + 1) b / n)`` of the global batch, as the JAX
package's ``reshape(n, b // n, ...)`` gives it, redistributed over the
batch's axes.  The metrics come back replicated, as plain tensors.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import wide
from repro_torch.models.model import Model
from repro_torch.models.params import place, replicate_like, shard
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    tree_flatten,
    tree_leaves,
)

__all__ = ["loss_fn", "make_train_step", "init_train_state"]

AUX_WEIGHT = 0.01


def loss_fn(model: Model, params, batch: Dict[str, torch.Tensor], *, remat: bool = False):
    """Mean next-token CE over the batch (+ MoE aux).

    The target logit is the JAX package's masked sum over the vocab dim,
    ``where(iota == tgt, logits, 0)`` summed, not a gather: on a mesh the
    vocab dim is sharded over "model", and the sum reduces each rank's
    columns with one all-reduce of scalars per token.  It is bit for bit
    the gather: one logit plus zeros."""
    logits, _, aux = model.forward(params, batch, remat=remat)
    tokens = batch["tokens"]
    logits = wide(logits[:, :-1])
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    iota = replicate_like(torch.arange(logits.shape[-1], device=logits.device), logits)
    tgt_logit = torch.where(iota == tgt[..., None], logits, 0.0).sum(-1)
    ce = torch.mean(lse - tgt_logit)
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def init_train_state(model: Model, generator: torch.Generator, opt_cfg: AdamWConfig,
                     device=None):
    """Parameters from ``generator`` and zero moments, on ``device``
    (default: the card)."""
    params = model.init(generator, device=device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _split_micro(batch: Dict[str, torch.Tensor], n: int) -> list:
    """The ``n`` microbatches: rows ``[i b / n, (i + 1) b / n)`` each, the
    JAX package's ``reshape(n, b // n, ...)``, constrained to the batch's
    spec (on a mesh: redistributed over its axes)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} microbatches")
        m = b // n
        return [shard(x[i * m:(i + 1) * m], "batch", *([None] * (x.dim() - 1)))
                for i in range(n)]

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _replicated(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    n_microbatch: int = 1,
    remat: bool = True,
    param_shardings=None,
    acc_dtype=torch.float32,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    metrics are tensors on the state's device (reading one syncs)."""
    shardings = None if param_shardings is None else tree_leaves(param_shardings)

    def constrain(leaves):
        if shardings is None:
            return leaves
        return [place(t, s) for t, s in zip(leaves, shardings)]

    def grads_of(params, batch):
        leaves, rebuild = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss, parts = loss_fn(model, rebuild(live), batch, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        return (_replicated(loss.detach()), {k: _replicated(v.detach()) for k, v in parts.items()},
                constrain(grads), rebuild)

    def train_step(state, batch):
        params = state["params"]
        if n_microbatch == 1:
            loss, parts, grads, rebuild = grads_of(params, batch)
        else:
            acc = None
            losses, ces = [], []
            for mb in _split_micro(batch, n_microbatch):
                loss, parts, g, rebuild = grads_of(params, mb)
                if acc is None:
                    acc = [torch.zeros_like(p, dtype=acc_dtype) for p in g]
                for a, gg in zip(acc, g):
                    a.add_(gg.to(acc_dtype) / n_microbatch)
                del g
                losses.append(loss)
                ces.append(parts["ce"])
            grads = acc
            loss = torch.stack(losses).mean()
            parts = {"ce": torch.stack(ces).mean(), "aux": torch.zeros((), device=loss.device)}
        new_params, new_opt, om = adamw_update(params, rebuild(grads), state["opt"], opt_cfg)
        metrics = {k: _replicated(v) for k, v in {"loss": loss, **parts, **om}.items()}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
