"""The port's graph package against the JAX package's ``repro.graph``.

Adjacency construction is numpy on both sides and must give equal arrays.
Aggregation and the GCN / GraphSAGE forwards run on the same graph with
the same features (seeded numpy) and the same weights — the JAX package's
``init_gcn`` / ``init_sage`` parameters carried into the port's modules.
The JAX side runs its aggregators on their default ``"stable"`` jnp path
(its fused kernel in interpret mode where named); the port runs on the
CPU, where the kernel wrappers take their plain PyTorch versions.

Tolerances: sum and mean aggregation ``rtol=1e-5, atol=1e-5 * max(1,
|y_jax|_inf)`` (lane sums in different orders), max aggregation exactly,
logits ``rtol=1e-4, atol=1e-4 * max(1, |logits_jax|_inf)`` (three layers
of dense products and aggregations, each rounded differently).
"""
import jax
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro.serving as jserving
import repro_torch.graph as tg
import repro_torch.serving as tserving

N = 512
DIMS = [16, 32, 32, 7]


def _close(y_port, y_jax, rtol=1e-5):
    y_jax = np.asarray(y_jax)
    atol = rtol * max(1.0, float(np.abs(y_jax).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(y_port), y_jax, rtol=rtol, atol=atol)


def _same(y_port, y_jax, op):
    if op == "max":
        np.testing.assert_array_equal(np.asarray(y_port), np.asarray(y_jax))
    else:
        _close(y_port, y_jax)


def _edges(seed=0, n=60, m=300):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m), rng.random(m).astype(np.float32)


BUILDERS = {
    "edges": lambda g: g.graph_from_edges(*_edges()[:2], n_nodes=60),
    "edges_weighted_sym_loops": lambda g: g.graph_from_edges(
        *_edges()[:2], weights=_edges()[2], symmetric=True, self_loops=True
    ),
    "edges_no_dedup": lambda g: g.graph_from_edges(*_edges(1)[:2], dedup=False),
    "self_loops": lambda g: g.add_self_loops(g.rmat_graph(256, 6.0, seed=1), weight=2.0),
    "norm_sym": lambda g: g.normalize_adjacency(g.add_self_loops(g.rmat_graph(256, 6.0, seed=2))),
    "norm_row": lambda g: g.normalize_adjacency(g.power_law_graph(300, 5.0, seed=3), "row"),
    "norm_none": lambda g: g.normalize_adjacency(g.power_law_graph(300, 5.0, seed=3), "none"),
    "rmat": lambda g: g.rmat_graph(1000, 8.0, seed=4, symmetric=False, self_loops=True),
    "power_law": lambda g: g.power_law_graph(N, 6.0, seed=5, exponent=1.1),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_graph_arrays_equal_jax(name):
    a_j, a_t = BUILDERS[name](jg), BUILDERS[name](tg)
    assert a_t.shape == a_j.shape
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a_t, field), getattr(a_j, field))
        assert getattr(a_t, field).dtype == getattr(a_j, field).dtype
    for weighted in (False, True):
        np.testing.assert_array_equal(
            tg.degrees(a_t, weighted=weighted), jg.degrees(a_j, weighted=weighted)
        )


@pytest.fixture(scope="module")
def graph():
    """A power-law graph with isolated nodes, on both sides, and features."""
    a_j = jg.power_law_graph(N, 6.0, seed=3)
    a_t = tg.power_law_graph(N, 6.0, seed=3)
    assert np.any(np.diff(a_t.indptr) == 0)  # isolated nodes: mean/max give 0
    x = np.random.default_rng(0).standard_normal((N, DIMS[0])).astype(np.float32)
    return a_j, a_t, x


@pytest.mark.parametrize("op", tg.AGGREGATIONS)
@pytest.mark.parametrize("strategy", ["fused", "partials", "stable"])
def test_make_aggregator_matches_jax(graph, op, strategy):
    a_j, a_t, x = graph
    y_j = jg.make_aggregator(a_j, op=op)(x)
    agg = tg.make_aggregator(a_t, op=op, strategy=strategy, device="cpu")
    _same(agg(x), y_j, op)
    _same(agg(torch.as_tensor(x)), y_j, op)


@pytest.mark.parametrize("op", tg.AGGREGATIONS)
def test_aggregate_matches_jax(graph, op):
    """One-shot aggregation over prebuilt tiles; the JAX side runs its fused
    Pallas kernel in interpret mode."""
    a_j, a_t, x = graph
    from repro.core.tile import build_tiles as jbuild
    from repro.core.tile import tuned_partition_config as jtuned
    from repro_torch.core.tile import build_tiles as tbuild
    from repro_torch.core.tile import tuned_partition_config as ttuned

    tj, tt = jbuild(a_j, jtuned(a_j)), tbuild(a_t, ttuned(a_t))
    deg_j = jg.degrees(a_j) if op == "mean" else None
    deg_t = tg.degrees(a_t) if op == "mean" else None
    y_j = jg.aggregate(tj, x, op=op, degree=deg_j, strategy="fused", interpret=True)
    _same(tg.aggregate(tt, x, op=op, degree=deg_t, device="cpu"), y_j, op)
    if op == "mean":
        with pytest.raises(ValueError, match="degree"):
            tg.aggregate(tt, x, op="mean", device="cpu")


@pytest.mark.parametrize("op", tg.AGGREGATIONS)
@pytest.mark.parametrize("strategy", ["fused", "partials", "stable"])
def test_plan_aggregator_matches_jax(graph, tmp_path, op, strategy):
    a_j, a_t, x = graph
    jreg = jserving.MatrixRegistry(cache_dir=tmp_path / "jax", search=False)
    treg = tserving.MatrixRegistry(
        device="cpu", cache_dir=tmp_path / "torch", search=False, strategy=strategy
    )
    y_j = jg.plan_aggregator(jreg.admit(a_j, "g"), op=op)(x)
    plan = treg.admit(a_t, "g")
    _same(tg.plan_aggregator(plan, op=op)(x), y_j, op)
    # the mean divisor is staged once, on the plan's device
    if op == "mean":
        assert plan._mean_div.shape == (N, 1) and plan._mean_div.device == plan.device.device


def test_aggregation_rejects_unknown_ops_and_defers_autodiff(graph, tmp_path):
    _, a_t, _ = graph
    with pytest.raises(ValueError, match="aggregation"):
        tg.make_aggregator(a_t, op="min", device="cpu")
    treg = tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path, search=False)
    plan = treg.admit(a_t, "g")
    with pytest.raises(ValueError, match="aggregation"):
        tg.plan_aggregator(plan, op="min")
    # the differentiable aggregators are served now; they reject unknown
    # ops alike, and sum/mean over a plan need its linked transpose
    with pytest.raises(ValueError, match="aggregation"):
        tg.make_diff_aggregator(a_t, op="min", device="cpu")
    with pytest.raises(ValueError, match="aggregation"):
        tg.plan_diff_aggregator(plan, op="min")
    with pytest.raises(ValueError, match="admit_pair"):
        tg.plan_diff_aggregator(plan, op="sum")
    x = torch.ones((a_t.shape[1], 2))
    assert tg.make_diff_aggregator(a_t, op="sum", device="cpu")(x).shape == (a_t.shape[0], 2)
    assert tg.plan_diff_aggregator(plan, op="max")(x).shape == (a_t.shape[0], 2)


def _carried(params):
    """JAX parameter lists as numpy arrays, field by field."""
    return [tuple(np.asarray(f) for f in p) for p in params]


# (model, aggregation, graph transform) of each forward
FORWARDS = {
    "gcn": ("gcn", "sum", lambda g, a: g.normalize_adjacency(g.add_self_loops(a), "sym")),
    "sage-mean": ("sage", "mean", lambda g, a: a),
    "sage-max": ("sage", "max", lambda g, a: a),
}


@pytest.mark.parametrize("served", [False, True], ids=["staged", "served"])
@pytest.mark.parametrize("strategy", ["fused", "partials", "stable"])
@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_matches_jax_with_carried_weights(graph, tmp_path, name, strategy, served):
    a_j, a_t, x = graph
    model, op, transform = FORWARDS[name]
    adj_j, adj_t = transform(jg, a_j), transform(tg, a_t)
    key = jax.random.PRNGKey(7)
    if model == "gcn":
        params, fwd, module = jg.init_gcn(key, DIMS), jg.gcn_forward, tg.GCN
    else:
        params, fwd, module = jg.init_sage(key, DIMS), jg.sage_forward, tg.GraphSAGE
    logits_j = np.asarray(fwd(jg.make_aggregator(adj_j, op=op), params, x))
    if served:
        treg = tserving.MatrixRegistry(
            device="cpu", cache_dir=tmp_path, search=False, strategy=strategy
        )
        agg = tg.plan_aggregator(treg.admit(adj_t, "g"), op=op)
    else:
        agg = tg.make_aggregator(adj_t, op=op, strategy=strategy, device="cpu")
    net = module.from_params(_carried(params), device="cpu")
    if strategy == "stable":
        # the modules' parameters are trainable: the plain chain's logits
        # carry their graph
        logits_t = net(agg, torch.as_tensor(x))
        assert logits_t.requires_grad
        logits_t = logits_t.detach()
    else:
        # the kernels record no graph: under grad mode they refuse, as on
        # the card, and name the differentiable aggregators
        with pytest.raises(RuntimeError, match="make_diff_aggregator"):
            net(agg, torch.as_tensor(x))
        with torch.no_grad():
            logits_t = net(agg, torch.as_tensor(x))
    assert logits_t.shape == (N, DIMS[-1])
    _close(logits_t, logits_j, rtol=1e-4)
    # the functional forward over the module's parameters is the same code
    t_fwd = tg.gcn_forward if model == "gcn" else tg.sage_forward
    with torch.no_grad():
        assert torch.equal(t_fwd(agg, net.params(), torch.as_tensor(x)), logits_t)


def test_modules_from_a_generator_and_weight_loading(graph):
    _, a_t, x = graph
    agg = tg.make_aggregator(a_t, op="max", device="cpu")
    a = tg.GraphSAGE(DIMS, generator=torch.Generator().manual_seed(1))
    b = tg.GraphSAGE(DIMS, generator=torch.Generator().manual_seed(1))
    c = tg.GraphSAGE(DIMS, generator=torch.Generator().manual_seed(2))
    xt = torch.as_tensor(x)
    assert torch.equal(a(agg, xt), b(agg, xt)) and not torch.equal(a(agg, xt), c(agg, xt))
    assert [tuple(p.W_self.shape) for p in a.params()] == [(16, 32), (32, 32), (32, 7)]
    assert all(torch.equal(p.b, torch.zeros_like(p.b)) for p in a.params())
    c.load_params([tuple(t.detach().numpy() for t in p) for p in a.params()])
    assert torch.equal(a(agg, xt), c(agg, xt))
    with pytest.raises(ValueError, match="shape"):
        c.load_params([tuple(np.zeros((2, 2), np.float32) for _ in p) for p in a.params()])
    with pytest.raises(ValueError, match="layers"):
        c.load_params(_carried(jg.init_sage(jax.random.PRNGKey(0), DIMS[:2])))
    gcn = tg.GCN(DIMS, generator=torch.Generator().manual_seed(3))
    assert [tuple(p.W.shape) for p in gcn.params()] == [(16, 32), (32, 32), (32, 7)]
    assert sum(1 for _ in gcn.parameters()) == 6
