"""Node-classification objectives over GNN logits.

Masked means throughout: mini-batch training supervises the *seed* rows
only (the sampled context exists to feed their aggregation), and
full-graph training may hold out validation/test node sets — both are the
same masked cross-entropy.  The formulas are the JAX package's
(``repro.graph.train.loss``), written out so both packages compute alike.
"""
from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy", "accuracy"]


def _masked_mean(values: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return values.mean()
    m = torch.as_tensor(mask, dtype=values.dtype, device=values.device).reshape(values.shape)
    return (values * m).sum() / m.sum().clamp(min=1.0)


def _labels(labels, device) -> torch.Tensor:
    return torch.as_tensor(labels, device=device).long()


def softmax_cross_entropy(logits: torch.Tensor, labels, mask=None) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [n, C] vs integer ``labels`` [n].

    ``mask`` (optional, [n], nonzero = supervised) restricts the mean to
    the supervised rows; an all-zero mask yields 0 rather than NaN.
    """
    labels = _labels(labels, logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return _masked_mean(nll, mask)


def accuracy(logits: torch.Tensor, labels, mask=None) -> torch.Tensor:
    """Fraction of (masked) rows whose argmax matches the label."""
    labels = _labels(labels, logits.device)
    hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    return _masked_mean(hit, mask)
