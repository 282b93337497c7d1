"""The port's GNN training against the JAX package's.

Sampling is numpy on both sides and must give equal batches.  The losses,
AdamW and the trainer run on the same graph, features and labels (seeded
numpy) from the same weights and optimizer state — the JAX package's
``init_gcn`` / ``init_sage`` draw and its AdamW state carried into the
port.  One AdamW step agrees within float32 rounding (``rtol=1e-6``) and
its int8 moments' ``q`` tensors are equal; the trainers' loss histories
(``fit`` for GCN, SAGE-mean and SAGE-max; ``fit_sampled`` for SAGE-mean)
agree per step within ``rtol=1e-4, atol=1e-5``, with the sampled batches
equal.  The port runs on the CPU (``"stable"`` strategy, the plain
versions of the kernels), the JAX side on its default ``"stable"`` path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro.optim.adamw as jadamw
from repro.graph.train import NodeClassifierTrainer as JTrainer
from repro.graph.train import accuracy as j_accuracy
from repro.graph.train import sample_neighbors as j_sample
from repro.graph.train import softmax_cross_entropy as j_xent
from repro.graph.train import subgraph as j_subgraph
from repro.serving import MatrixRegistry as JRegistry
import repro_torch.graph as tg
import repro_torch.optim.adamw as tadamw
from repro_torch.graph.train import NodeClassifierTrainer as TTrainer
from repro_torch.graph.train import accuracy as t_accuracy
from repro_torch.graph.train import sample_neighbors as t_sample
from repro_torch.graph.train import softmax_cross_entropy as t_xent
from repro_torch.graph.train import subgraph as t_subgraph
from repro_torch.serving import MatrixRegistry

N = 240
DIMS = [16, 32, 8]
TOL = dict(rtol=1e-4, atol=1e-5)
ADAMW = dict(lr_peak=2e-2, warmup_steps=2, decay_steps=50, weight_decay=0.01)


@pytest.fixture(scope="module")
def data():
    a_j = jg.power_law_graph(N, 6.0, seed=3, symmetric=False)
    a_t = tg.power_law_graph(N, 6.0, seed=3, symmetric=False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, DIMS[0])).astype(np.float32)
    labels = rng.integers(0, DIMS[-1], N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    return a_j, a_t, x, labels, mask


def _carried(params):
    return [tuple(np.asarray(f) for f in p) for p in params]


def _carried_opt(opt_state):
    return {"m": opt_state["m"], "v": opt_state["v"], "step": np.asarray(opt_state["step"])}


# --- sampling --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
def test_sampled_batches_equal_jax(data, seed):
    a_j, a_t, _, _, _ = data
    seeds = [7, 50, 123, 200]
    b_j = j_sample(a_j, seeds, (5, 3), seed=seed)
    b_t = t_sample(a_t, seeds, (5, 3), seed=seed)
    np.testing.assert_array_equal(b_t.nodes, b_j.nodes)
    assert b_t.n_seeds == b_j.n_seeds
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(b_t.adj, field), getattr(b_j.adj, field))
    np.testing.assert_array_equal(b_t.seed_mask(), b_j.seed_mask())
    nodes = np.random.default_rng(seed).choice(N, 40, replace=False)
    s_j, s_t = j_subgraph(a_j, nodes), t_subgraph(a_t, nodes)
    np.testing.assert_array_equal(s_t.to_dense(), s_j.to_dense())


# --- losses ----------------------------------------------------------------


@pytest.mark.parametrize("masked", ["none", "mask", "empty"])
def test_loss_and_accuracy_match_jax(data, masked):
    _, _, _, labels, mask = data
    logits = np.random.default_rng(4).standard_normal((N, DIMS[-1])).astype(np.float32) * 3
    m = {"none": None, "mask": mask, "empty": np.zeros(N, np.float32)}[masked]
    lt = torch.as_tensor(logits)
    np.testing.assert_allclose(float(t_xent(lt, labels, m)),
                               float(j_xent(jnp.asarray(logits), labels, m)), rtol=1e-6)
    assert float(t_accuracy(lt, labels, m)) == float(j_accuracy(jnp.asarray(logits), labels, m))


# --- AdamW -----------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_step_matches_jax(state_dtype):
    rng = np.random.default_rng(1)
    params = [(rng.standard_normal((6, 5)).astype(np.float32),
               rng.standard_normal(5).astype(np.float32))] * 2
    grads = [(rng.standard_normal((6, 5)).astype(np.float32) * 3,
              rng.standard_normal(5).astype(np.float32))] * 2
    cfg_j = jadamw.AdamWConfig(**ADAMW, state_dtype=state_dtype)
    cfg_t = tadamw.AdamWConfig(**ADAMW, state_dtype=state_dtype)
    p_j = [tuple(jnp.asarray(a) for a in p) for p in params]
    p_t = [tuple(torch.as_tensor(a) for a in p) for p in params]
    s_j = jadamw.init_opt_state(p_j, cfg_j)
    s_t = tadamw.init_opt_state(p_t, cfg_t)
    for step in range(3):  # the third step starts from moments both carried
        g_j = [tuple(jnp.asarray(a * (step + 1)) for a in g) for g in grads]
        g_t = [tuple(torch.as_tensor(a * (step + 1)) for a in g) for g in grads]
        p_j, s_j, m_j = jadamw.adamw_update(p_j, g_j, s_j, cfg_j)
        p_t, s_t, m_t = tadamw.adamw_update(p_t, g_t, s_t, cfg_t)
        for a, b in zip(tadamw.tree_leaves(p_t), jax.tree.leaves(p_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-6)
        assert int(m_t["step"]) == int(m_j["step"]) == step + 1
        moments_t = tadamw.tree_leaves(s_t["m"]) + tadamw.tree_leaves(s_t["v"])
        moments_j = jax.tree.leaves(s_j["m"]) + jax.tree.leaves(s_j["v"])
        if state_dtype == "int8":
            # the JAX QTensor leaves flatten to (q, scale)
            flat_t = [x for q in moments_t for x in (q.q, q.scale)]
            for a, b in zip(flat_t, moments_j):
                if a.dtype == torch.int8:  # the q tensors are equal
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                else:
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            for a, b in zip(moments_t, moments_j):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
        # carry the JAX state across: the port continues from it
        s_t = tadamw.load_opt_state(_carried_opt(s_j))
        p_t = [tuple(torch.as_tensor(np.array(a)) for a in p) for p in p_j]


def test_lr_schedule_matches_jax():
    cfg_j, cfg_t = jadamw.AdamWConfig(**ADAMW), tadamw.AdamWConfig(**ADAMW)
    for s in (0, 1, 2, 3, 25, 52, 80):
        np.testing.assert_allclose(
            float(tadamw.lr_schedule(cfg_t, torch.tensor(s, dtype=torch.int32))),
            float(jadamw.lr_schedule(cfg_j, jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_grad_clipping_bounds_the_update():
    cfg = tadamw.AdamWConfig(grad_clip=1e-6, lr_peak=1.0, warmup_steps=0, decay_steps=1)
    params = {"w": torch.ones(4)}
    state = tadamw.init_opt_state(params, cfg)
    new, _, metrics = tadamw.adamw_update(params, {"w": torch.full((4,), 100.0)}, state, cfg)
    assert float(metrics["grad_norm"]) == 200.0
    assert torch.all(new["w"] < 1.0)


# --- the trainer -----------------------------------------------------------

# (model, op) of each loss-history comparison
RUNS = {"gcn": ("gcn", None), "sage-mean": ("sage", "mean"), "sage-max": ("sage", "max")}


def _trainers(model, op, **kw):
    jt = JTrainer(DIMS, model=model, op=op, adamw=jadamw.AdamWConfig(**ADAMW), **kw)
    tt = TTrainer(DIMS, model=model, op=op, adamw=tadamw.AdamWConfig(**ADAMW), device="cpu")
    return jt, tt


def _same_history(th, jh):
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert t["step"] == j["step"]
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], **TOL, err_msg=key)
        assert abs(t["accuracy"] - j["accuracy"]) <= 1.0 / N + 1e-7
        if "batch_nodes" in j:
            assert t["batch_nodes"] == j["batch_nodes"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fit_history_matches_jax(data, name):
    """Four full-graph steps from the same weights, then four more from
    the JAX state carried across (parameters and AdamW moments)."""
    a_j, a_t, x, labels, mask = data
    jt, tt = _trainers(*RUNS[name])
    js = jt.init(1)
    ts = tt.load_state(_carried(js.params))
    js, jh = jt.fit(a_j, x, labels, steps=4, state=js, mask=mask)
    ts, th = tt.fit(a_t, x, labels, steps=4, state=ts, mask=mask)
    _same_history(th, jh)
    ts = tt.load_state(_carried(js.params), _carried_opt(js.opt_state))
    js, jh = jt.fit(a_j, x, labels, steps=4, state=js)
    ts, th = tt.fit(a_t, x, labels, steps=4, state=ts)
    _same_history(th, jh)
    assert th[-1]["loss"] < th[0]["loss"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fit_sampled_matches_jax_and_reuses_admissions(data, tmp_path, name):
    """Two epochs of two neighbor-sampled batches through a registry on
    each side: the same batches, the same losses, and the second epoch
    admits nothing new."""
    a_j, a_t, x, labels, _ = data
    jt, tt = _trainers(*RUNS[name], registry=JRegistry(cache_dir=tmp_path / "j", search=False))
    tt.registry = MatrixRegistry(device="cpu", cache_dir=tmp_path / "t", search=False)
    js = jt.init(2)
    ts = tt.load_state(_carried(js.params))
    kw = dict(batch_size=120, fanouts=(4, 2), seed=5)
    js, jh = jt.fit_sampled(a_j, x, labels, steps=2, state=js, **kw)
    ts, th = tt.fit_sampled(a_t, x, labels, steps=2, state=ts, **kw)
    misses = tt.registry.metrics.value("registry.misses", 0)
    resident = len(tt.registry)
    # two batches, each a linked (A, Aᵀ) pair; max admits no transpose
    assert resident == (2 if name == "sage-max" else 4)
    js, jh2 = jt.fit_sampled(a_j, x, labels, steps=4, state=js, **kw)
    ts, th2 = tt.fit_sampled(a_t, x, labels, steps=4, state=ts, **kw)
    _same_history(th + th2, jh + jh2)
    assert len(tt.registry) == resident
    assert tt.registry.metrics.value("registry.misses", 0) == misses
    assert all(s["admissions"] >= 2 for s in tt.registry.stats().values())


def test_trainer_state_init_and_evaluate(data):
    _, a_t, x, labels, mask = data
    tt = TTrainer(DIMS, model="sage", op="max", device="cpu")
    s1, s2 = tt.init(3), tt.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(tadamw.tree_leaves(s1.params),
                                                   tadamw.tree_leaves(s2.params)))
    assert int(s1.opt_state["step"]) == 0
    agg = tt.aggregator(tt.prepare_adjacency(a_t))
    before = tt.evaluate(s1, agg, x, labels, mask)
    s3, metrics = tt.step(s1, agg, x, labels, mask)
    assert metrics["step"] == 1 and np.isclose(metrics["loss"], before["loss"], rtol=1e-6)
    assert not any(p.requires_grad for p in tadamw.tree_leaves(s3.params))
    with pytest.raises(ValueError, match="unknown model"):
        TTrainer(DIMS, model="gin", device="cpu")
    with pytest.raises(ValueError, match="dims"):
        TTrainer([4], device="cpu")


def test_gnn_modules_train(data):
    """The modules' parameters take gradients through the differentiable
    aggregators (the transpose SpMM for GCN's sum)."""
    _, a_t, x, _, _ = data
    gcn = tg.GCN(DIMS, generator=torch.Generator().manual_seed(0))
    agg = tg.make_diff_aggregator(
        tg.normalize_adjacency(tg.add_self_loops(a_t), "sym"), op="sum", device="cpu")
    gcn(agg, torch.as_tensor(x)).square().mean().backward()
    grads = [p.grad for p in gcn.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
