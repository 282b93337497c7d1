"""Faults planted in the program, for the checks that ``correct`` has to
come out false on them: a step that returns its state unchanged; half of
the nodes left out (the loss's mean taken over the rest, or the forward's
answers for the rest missing); one node's aggregated answer altered where
it is produced (every feature of node 0, +1; node 0 is the R-MAT graph's
largest hub)."""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(fault: str):
    """Patch the program with ``fault`` for the duration of the block.
    Aggregators made inside the block carry an ``"altered"`` fault."""
    import torch
    from repro_torch.graph import layers_gnn
    from repro_torch.graph.train import trainer
    from repro_torch.serving.registry import MatrixPlan

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (expected one of {FAULTS})")
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged":
        step = trainer.NodeClassifierTrainer.step

        def same_state(self, state, *args, **kwargs):
            _, out = step(self, state, *args, **kwargs)
            return state, out

        patch(trainer.NodeClassifierTrainer, "step", same_state)
    elif fault == "half_batch":
        loss = trainer.softmax_cross_entropy

        def half_loss(logits, labels, mask=None):
            n = logits.shape[0] // 2
            return loss(logits[:n], labels[:n])

        patch(trainer, "softmax_cross_entropy", half_loss)
        for name in [n for n in vars(layers_gnn) if n.endswith("_forward")]:
            def half_forward(agg, params, x, *, activation=torch.relu,
                             forward=getattr(layers_gnn, name)):
                out = forward(agg, params, x, activation=activation).clone()
                out[out.shape[0] // 2:] = 0.0
                return out

            patch(layers_gnn, name, half_forward)
    else:
        def bump(y):
            y = y.clone()
            y[0] = y[0] + 1.0
            return y

        aggregate, diff_aggregator = MatrixPlan.aggregate, MatrixPlan.diff_aggregator
        patch(MatrixPlan, "aggregate", lambda self, x, **kw: bump(aggregate(self, x, **kw)))

        def altered_diff(self, **kw):
            agg = diff_aggregator(self, **kw)
            return lambda x: bump(agg(x))

        patch(MatrixPlan, "diff_aggregator", altered_diff)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
