"""The port's differentiable aggregation against the JAX package's.

Both packages get the same paired tiles (the JAX ``hbp_transpose`` build
carried over) and the same x and cotangents from seeded numpy.  Gradients
(``mode="vjp"`` and ``"jvp"``, ops sum, mean and max) and forward-mode
tangents are held against ``jax.grad`` / ``jax.jvp`` within ``rtol=1e-4,
atol=1e-5``; a finite-difference check (``torch.autograd.gradcheck`` at
the tolerances of ``tests/test_autodiff.py``) and order 2 run on the port
alone and against JAX.  The port runs on the CPU, where the kernel
wrappers take their plain PyTorch versions; the JAX side runs its
``"stable"`` path, as its own tests do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graph as jg
from repro.kernels import autodiff as jad
import repro_torch.core as tcore
import repro_torch.graph as tg
from repro_torch.kernels import autodiff as tad
from repro_torch.kernels import ops as tops
from repro_torch.serving import MatrixRegistry

FIELDS = ("data", "cols", "rowgroup", "colblock", "first", "perm")
TOL = dict(rtol=1e-4, atol=1e-5)
CHECK = dict(atol=5e-2, rtol=5e-2, eps=1e-2)  # tests/test_autodiff.py's fp32 tolerances


def _carry(tj):
    d = {f: getattr(tj, f) for f in FIELDS}
    d.update(shape=tj.shape, n_rowgroups=tj.n_rowgroups, cfg=dataclasses.asdict(tj.cfg))
    return tcore.tiles_from_arrays(d)


def _carry_pair(pj):
    return tad.PairedTiles(_carry(pj.tiles), _carry(pj.tiles_T))


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    dense = (rng.standard_normal((37, 29)) * (rng.random((37, 29)) < 0.25)).astype(np.float32)
    dense[5] = 0.0  # an empty row
    csr = jcore.csr_from_dense(dense)
    cfg = jcore.PartitionConfig(row_block=16, col_block=16, group=4, lane=4)
    pj = jad.hbp_transpose(csr, cfg, cfg)
    return csr, dense, pj, _carry_pair(pj)


def _x(n, k=5, seed=1):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _distinct_int_x(n_cols: int, k: int, seed: int) -> np.ndarray:
    """Per-column distinct integers: against a binary adjacency every
    argmax margin is >= 1, so finite-difference probes never flip a
    winner (as ``tests/test_autodiff.py`` draws them)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_cols) - n_cols // 2 for _ in range(k)], 1).astype(
        np.float32)


def _pair_aggs(pj, pt, op, mode, degree):
    fj = jad.diff_aggregator(pj, op=op, degree=degree, mode=mode)
    ft = tad.diff_aggregator(pt, op=op, degree=degree, mode=mode, device="cpu")
    return fj, ft


def _torch_grad(f, x, w):
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad((f(xt) * torch.as_tensor(w)).sum(), xt)
    return g.numpy()


@pytest.mark.parametrize("mode", ["vjp", "jvp"])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_grad_matches_jax(small, op, mode):
    csr, _, pj, pt = small
    deg = jg.degrees(csr) if op == "mean" else None
    fj, ft = _pair_aggs(pj, pt, op, mode, deg)
    x = _x(csr.n_cols)
    w = _x(csr.n_rows, seed=5)
    y_t = ft(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(y_t, np.asarray(fj(jnp.asarray(x))), **TOL)
    g_j = jax.grad(lambda v: jnp.sum(fj(v) * w))(jnp.asarray(x))
    np.testing.assert_allclose(_torch_grad(ft, x, w), np.asarray(g_j), **TOL)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_jvp_matches_jax(small, op):
    """Forward mode through ``torch.func.jvp``: the tangent is a second A
    launch (sum, mean) or the gather through the saved winners (max)."""
    csr, _, pj, pt = small
    deg = jg.degrees(csr) if op == "mean" else None
    fj, ft = _pair_aggs(pj, pt, op, "jvp", deg)
    x, t = _x(csr.n_cols), _x(csr.n_cols, seed=2)
    y_j, t_j = jax.jvp(fj, (jnp.asarray(x),), (jnp.asarray(t),))
    y_t, t_t = torch.func.jvp(ft, (torch.as_tensor(x),), (torch.as_tensor(t),))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), **TOL)


@pytest.mark.parametrize("mode", ["vjp", "jvp"])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_linear_finite_differences_and_order_two(small, op, mode):
    csr, _, pj, pt = small
    deg = jg.degrees(csr) if op == "mean" else None
    fj, ft = _pair_aggs(pj, pt, op, mode, deg)
    x = _x(csr.n_cols)

    def f64(v):
        return ft(v.to(torch.float32)).to(torch.float64)

    xd = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(f64, (xd,), **CHECK)
    assert torch.autograd.gradgradcheck(f64, (xd,), **CHECK)
    # order 2 against JAX: grad of a quadratic's gradient
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad((ft(xt) ** 2).sum(), xt, create_graph=True)
    (h,) = torch.autograd.grad((g * torch.as_tensor(x)).sum(), xt)
    h_j = jax.grad(lambda v: jnp.sum(jax.grad(lambda u: jnp.sum(fj(u) ** 2))(v) * x))(
        jnp.asarray(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)


def test_max_finite_differences_and_order_two(small):
    csr, dense, _, _ = small
    binary = jcore.csr_from_dense((dense != 0).astype(np.float32))
    cfg = jcore.PartitionConfig(row_block=16, col_block=16, group=4, lane=4)
    pj = jad.hbp_transpose(binary, cfg, cfg)
    pt = _carry_pair(pj)
    ft = tad.diff_aggregator(pt, op="max", device="cpu")
    fj = jad.diff_aggregator(pj, op="max")
    x = _distinct_int_x(binary.n_cols, 5, seed=1)

    def f64(v):
        return ft(v.to(torch.float32)).to(torch.float64)

    xd = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(f64, (xd,), **CHECK)
    assert torch.autograd.gradgradcheck(f64, (xd,), **CHECK)
    w = _x(binary.n_rows, seed=4)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    (g,) = torch.autograd.grad((ft(xt) * wt).sum(), xt, create_graph=True)
    g_j = jax.grad(lambda v: jnp.sum(fj(v) * w))(jnp.asarray(x))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_j), **TOL)
    # order 2: the backward is a scatter of the cotangent (its derivative
    # in x is 0, in the cotangent the gather through the winners)
    h_x, h_w = torch.autograd.grad((g ** 2).sum(), (xt, wt), allow_unused=True)
    assert h_x is None or torch.all(h_x == 0)
    h_j = jax.grad(lambda u: jnp.sum(jax.grad(lambda v: jnp.sum(fj(v) * u))(x) ** 2))(
        jnp.asarray(w))
    np.testing.assert_allclose(h_w.numpy(), np.asarray(h_j), **TOL)


def test_cotangents_of_any_layout_reach_the_kernels(small):
    """Expanded (``sum()``'s), transposed and float64 cotangents: the
    backward makes them contiguous float32 before the transpose SpMM."""
    csr, _, pj, pt = small
    ft = tad.diff_aggregator(pt, op="sum", device="cpu")
    fj = jad.diff_aggregator(pj, op="sum")
    x = _x(csr.n_cols)
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(ft(xt).sum(), xt)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jax.grad(lambda v: jnp.sum(fj(v)))(jnp.asarray(x))), **TOL)
    ct = torch.as_tensor(_x(5, k=csr.n_rows, seed=3)).T  # a transposed view
    y = ft(xt)
    (g2,) = torch.autograd.grad(y, xt, ct.double().float())
    (g3,) = torch.autograd.grad(ft(xt), xt, ct.contiguous())
    assert torch.equal(g2, g3)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_empty_rows_pass_no_gradient(op):
    G = tg.graph_from_edges([0, 1, 2, 4], [1, 2, 0, 0], n_nodes=6)  # rows 3, 5 empty
    cfg = tcore.PartitionConfig(row_block=8, col_block=8, group=4, lane=4)
    pair = tad.hbp_transpose(G, cfg, cfg)
    f = tad.diff_aggregator(pair, op=op, degree=tg.degrees(G), device="cpu")
    w = np.zeros((6, 3), np.float32)
    w[[3, 5]] = 7.0
    g = _torch_grad(f, _x(6, k=3), w)
    assert np.isfinite(g).all() and np.all(g == 0)


def test_tied_max_routes_to_lowest_column():
    D = np.zeros((3, 3), np.float32)
    D[0, 1] = D[0, 2] = 2.0
    cfg = tcore.PartitionConfig(row_block=4, col_block=4, group=2, lane=2)
    pair = tad.hbp_transpose(tcore.csr_from_dense(D), cfg, cfg)
    f = tad.diff_aggregator(pair, op="max", device="cpu")
    xt = torch.full((3, 2), 3.0, requires_grad=True)
    (g,) = torch.autograd.grad(f(xt)[0, 0], xt)
    expect = torch.zeros(3, 2)
    expect[1, 0] = 2.0  # the whole cotangent times coeff to column 1
    assert torch.equal(g, expect)


def test_hbp_transpose_pair_matches_dense(small):
    csr, dense, pj, _ = small
    pt = tad.hbp_transpose(tcore.csr_from_dense(dense), pj.tiles.cfg, pj.tiles_T.cfg)
    for a, b in ((pt.tiles, pj.tiles), (pt.tiles_T, pj.tiles_T)):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    x, g = _x(csr.n_cols), _x(csr.n_rows, seed=2)
    y = tops.hbp_spmm(pt.tiles, x, strategy="stable", device="cpu")
    yt = tops.hbp_spmm(pt.tiles_T, g, strategy="stable", device="cpu")
    np.testing.assert_allclose(y.numpy(), dense @ x, **TOL)
    np.testing.assert_allclose(yt.numpy(), dense.T @ g, **TOL)
    tall = tad.hbp_transpose(tcore.csr_from_dense((np.eye(200, 40) + 1).astype(np.float32)))
    assert tall.tiles.shape == (200, 40) and tall.tiles_T.shape == (40, 200)


def test_validation_messages(small):
    csr, _, _, pt = small
    with pytest.raises(ValueError, match="unknown mode"):
        tad.diff_aggregator(pt, op="sum", mode="hvp", device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation"):
        tad.diff_aggregator(pt, op="median", device="cpu")
    with pytest.raises(ValueError, match="degree"):
        tad.diff_aggregator(pt, op="mean", device="cpu")
    meta = dict(n_rowgroups=pt.tiles.n_rowgroups, n_rows=csr.n_rows,
                col_block=pt.tiles.cfg.col_block, strategy="stable")
    with pytest.raises(ValueError, match="transpose tiles"):
        tad.device_diff_aggregator(tops.device_tiles(pt.tiles, "cpu"), None, meta, None, op="sum")
    # max and jvp never stage the transpose
    tad.diff_aggregator(tad.PairedTiles(pt.tiles, None), op="max", device="cpu")
    tad.diff_aggregator(tad.PairedTiles(pt.tiles, None), op="sum", mode="jvp", device="cpu")
    assert tad.needs_transpose("sum", "vjp") and not tad.needs_transpose("max", "vjp")
    assert not tad.needs_transpose("mean", "jvp")
    # one home for the clamp convention
    assert tg.mean_divisor is tad.mean_divisor
    np.testing.assert_array_equal(
        tad.mean_divisor(np.array([0, 2, 5]), 3).numpy()[:, 0], [1.0, 2.0, 5.0])


def test_make_diff_aggregator_matches_jax():
    a_j = jg.power_law_graph(120, 5.0, seed=8, symmetric=False)
    a_t = tg.power_law_graph(120, 5.0, seed=8, symmetric=False)
    x, w = _x(120, k=4), _x(120, k=4, seed=6)
    for op in ("sum", "mean", "max"):
        fj = jg.make_diff_aggregator(a_j, op=op)
        ft = tg.make_diff_aggregator(a_t, op=op, device="cpu")
        g_j = jax.grad(lambda v: jnp.sum(fj(v) * w))(jnp.asarray(x))
        np.testing.assert_allclose(_torch_grad(ft, x, w), np.asarray(g_j), **TOL)


def test_admit_pair_links_and_plan_gradients_match_jax(tmp_path):
    from repro.serving import MatrixRegistry as JRegistry

    a_j = jg.power_law_graph(90, 4.0, seed=8, symmetric=False)
    a_t = tg.power_law_graph(90, 4.0, seed=8, symmetric=False)
    reg = MatrixRegistry(device="cpu", cache_dir=tmp_path / "t", search=False)
    lone = reg.admit(a_t, "lone")
    with pytest.raises(ValueError, match="admit_pair"):
        lone.diff_aggregator(op="sum")
    with pytest.raises(KeyError, match="no linked transpose"):
        reg.transpose_of(lone)
    reg2 = MatrixRegistry(device="cpu", cache_dir=tmp_path / "t2", search=False)
    plan = reg2.admit_pair(a_t, "g")
    assert reg2.transpose_of(plan).name == "g::T" and plan.transpose_name == "g::T"
    assert reg2.transpose_of(reg2.transpose_of(plan)) is plan
    assert reg2.admit_pair(a_t) is plan  # re-admission: free, both sides counted
    assert plan.admissions == 2 and reg2.transpose_of(plan).admissions == 2
    jreg = JRegistry(cache_dir=tmp_path / "j", search=False)
    jplan = jreg.admit_pair(a_j, "g")
    x, w = _x(90, k=4), _x(90, k=4, seed=7)
    for op in ("sum", "mean", "max"):
        for mode in ("vjp", "jvp"):
            ft = tg.plan_diff_aggregator(plan, op=op, mode=mode)
            fj = jg.plan_diff_aggregator(jplan, op=op, mode=mode)
            g_j = jax.grad(lambda v: jnp.sum(fj(v) * w))(jnp.asarray(x))
            np.testing.assert_allclose(_torch_grad(ft, x, w), np.asarray(g_j), **TOL)
    lone.diff_aggregator(op="max")  # max needs no transpose link
    reg2.evict("g::T")  # a full eviction dissolves the link
    assert plan.transpose_name is None
    with pytest.raises(ValueError, match="admit_pair"):
        plan.diff_aggregator(op="mean")


def test_symmetric_matrix_self_links(tmp_path):
    a = tg.normalize_adjacency(tg.add_self_loops(tg.rmat_graph(256, 6.0, seed=1)), "sym")
    reg = MatrixRegistry(device="cpu", cache_dir=tmp_path, search=False)
    plan = reg.admit_pair(a, "a_hat")
    assert reg.transpose_of(plan) is plan and plan.transpose_name == "a_hat"
    assert len(reg) == 1  # one residency serves both directions
    f = tg.plan_diff_aggregator(plan, op="sum")
    x = torch.tensor(_x(256, k=3), requires_grad=True)
    (g,) = torch.autograd.grad(f(x).sum(), x)
    dense = a.to_dense()
    np.testing.assert_allclose(g.numpy(), dense.T @ np.ones((256, 3), np.float32), **TOL)


def test_linked_pair_is_evicted_and_restaged_as_a_unit(tmp_path):
    reg = MatrixRegistry(device="cpu", cache_dir=tmp_path, search=False, hbm_budget_bytes=1)
    a = tg.power_law_graph(64, 4.0, seed=2, symmetric=False)
    plan = reg.admit_pair(a, "a")
    plan_T = reg.transpose_of(plan)
    assert plan.device is not None and plan_T.device is not None  # the pinned unit
    other = reg.admit(tg.power_law_graph(64, 4.0, seed=3), "b")
    assert plan.device is None and plan_T.device is None  # evicted together
    assert other.device is not None
    assert reg.get("a") is plan and plan.device is not None and plan_T.device is not None
    assert reg.metrics.value("evict.restages", 0, matrix="a::T") == 1
    f = tg.plan_diff_aggregator(plan, op="mean")
    x = torch.tensor(_x(64, k=2), requires_grad=True)
    torch.autograd.grad(f(x).sum(), x)


def test_only_the_solver_surface_stays_deferred(tmp_path):
    reg = MatrixRegistry(device="cpu", cache_dir=tmp_path, search=False)
    plan = reg.admit(tg.power_law_graph(32, 3.0, seed=1), "p")
    for method in (plan.operator, plan.jacobi):
        with pytest.raises(NotImplementedError, match="item 5"):
            method()
    X = np.random.default_rng(0).standard_normal((32, 2)).astype(np.float32)
    y, idx, coeff = tops.hbp_spmm_argmax(plan.device, X)
    assert idx.dtype == torch.int32 and y.shape == idx.shape == coeff.shape == (32, 2)
    assert torch.equal(y, plan.matmat(X, combine="max"))
