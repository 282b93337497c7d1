"""The port's iterative solvers against the JAX package's, on the CPU.

Both packages get the same numpy matrices and right-hand sides (the
sizes and matrices of ``tests/test_solvers.py``); each builds its own
tiles with ``CFG`` (``tests/test_torch_admission.py`` holds the two
builds' arrays equal).  The JAX side runs as its own tests run it, the
HBP path of each strategy in interpret mode; the port runs the same
strategy with ``device="cpu"`` (the kernels' plain versions).  Lane sums
and inner products are reduced in different orders by the two, so a
solve is held to:

* the same iteration count and convergence flag;
* ``x`` within ``1e-5 * max|x_jax|`` (``RTOL``);
* the history within ``1e-5 * max|finite history|``, with NaN padding
  (and PageRank's ``inf`` slot 0) at the same slots.

Power iteration is the one named exception to equal counts: see
``POWER_BORDERLINE``.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.matrices as jmat
import repro.serving as jserving
import repro.solvers as J
import repro_torch.core as tcore
import repro_torch.core.matrices as tmat
import repro_torch.serving as tserving
import repro_torch.solvers as T
from repro_torch import obs as tobs
from repro_torch.solvers import base as tbase

CFG = dict(row_block=64, col_block=128, group=8, lane=16)
STRATEGIES = ["fused", "partials", "stable"]
RTOL = 1e-5

# SPD analogues of the suite's structural families (tests/test_solvers.py)
FAMILIES = {
    "rmat": lambda m: m.rmat(1 << 7, 900, seed=4),
    "circuit": lambda m: m.circuit(128, seed=1, n_dense_rows=2, dense_row_frac=0.05),
    "banded_fem": lambda m: m.banded_fem(128, seed=3, band=4, fill=0.9),
    "dense_block": lambda m: m.dense_block(128, seed=8, block=24, n_blocks=2, background=3.0),
}


def spd_family(name):
    A = FAMILIES[name](jmat).to_dense().astype(np.float64)
    n = A.shape[0]
    return (A @ A.T / n + np.eye(n)).astype(np.float32)


def spd64():
    rng = np.random.default_rng(0)
    G = rng.standard_normal((64, 64)).astype(np.float32) * (rng.random((64, 64)) < 0.3)
    return (G @ G.T / 64 + 2 * np.eye(64, dtype=np.float32)).astype(np.float32)


def badly_scaled_spd(n, rng):
    """SPD with a diagonal spanning 4 decades: S A S for A ~ I."""
    R = rng.standard_normal((n, n)) * 0.02
    A = np.eye(n) + R @ R.T
    s = 10.0 ** rng.uniform(-2, 2, n)
    S = (A * s).T * s
    return ((S + S.T) / 2).astype(np.float32)


def block_diag_dominant_spd(n, bs, rng, coupling=0.05):
    """SPD with strong [bs, bs] diagonal blocks and weak off-block coupling."""
    A = np.zeros((n, n))
    for lo in range(0, n, bs):
        B = rng.standard_normal((bs, bs))
        A[lo : lo + bs, lo : lo + bs] = B @ B.T + bs * np.eye(bs)
    R = rng.standard_normal((n, n)) * coupling
    return (A + R @ R.T).astype(np.float32)


class Pair:
    """One numpy matrix as each package's CSR and tiles."""

    def __init__(self, dense=None, *, jcsr=None, tcsr=None):
        self.jcsr = jcore.csr_from_dense(dense) if jcsr is None else jcsr
        self.tcsr = tcore.csr_from_dense(dense) if tcsr is None else tcsr
        self.jtiles = jcore.build_tiles(self.jcsr, jcore.PartitionConfig(**CFG))
        self.ttiles = tcore.build_tiles(self.tcsr, tcore.PartitionConfig(**CFG))

    def ops(self, strategy):
        return (J.aslinearoperator(self.jtiles, strategy=strategy, interpret=True),
                T.aslinearoperator(self.ttiles, strategy=strategy, device="cpu"))


def close_to(got, want, what, scale=None):
    """``got`` (port) within ``RTOL * scale`` of ``want`` (JAX), ``scale``
    being ``max|want|`` unless given; the same non-finite values at the
    same places."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite), f"{what}: non-finite slots differ"
    assert np.array_equal(got[~finite], want[~finite], equal_nan=True), what
    if finite.any():
        scale = np.abs(want[finite]).max() if scale is None else scale
        err = np.abs(got[finite] - want[finite]).max()
        assert err <= RTOL * scale, f"{what}: max abs err {err:.3e} over {RTOL} * {scale:.3e}"


def same_solve(rt, rj, what):
    assert int(rt.iterations) == int(rj.iterations), (
        what, int(rt.iterations), int(rj.iterations))
    assert bool(rt.converged) == bool(rj.converged), what
    close_to(rt.x, rj.x, f"{what} x")
    close_to(rt.history, rj.history, f"{what} history")
    # the final residual is the history's last entry, held to its scale
    hist = np.asarray(rj.history)
    close_to(rt.residual, rj.residual, f"{what} residual",
             scale=np.abs(hist[np.isfinite(hist)]).max())


# --- operators and preconditioners ------------------------------------------


@pytest.mark.parametrize("container", ["dense", "csr", "fused", "partials", "stable"])
def test_operator_adapters_match_repro(container):
    S = spd64()
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64).astype(np.float32)
    X = rng.standard_normal((64, 3)).astype(np.float32)
    if container == "dense":
        opj, opt = J.aslinearoperator(S), T.aslinearoperator(S, device="cpu")
    elif container == "csr":
        p = Pair(S)
        opj, opt = J.aslinearoperator(p.jcsr), T.aslinearoperator(p.tcsr, device="cpu")
    else:
        opj, opt = Pair(S).ops(container)
    assert opt.shape == (64, 64) and opt.device == torch.device("cpu")
    close_to(opt(torch.as_tensor(x)), opj(x), f"{container} matvec")
    close_to(opt(torch.as_tensor(X)), opj(X), f"{container} matmat")
    # matvec-only operators synthesize matmat column by column
    op = T.LinearOperator((64, 64), matvec=lambda v: opt.matvec(v), device="cpu")
    assert torch.equal(op.matmat(torch.as_tensor(X)),
                       torch.stack([opt.matvec(torch.as_tensor(X[:, j])) for j in range(3)], 1))


def test_operator_rejects_unknown():
    with pytest.raises(TypeError):
        T.aslinearoperator("not a matrix", device="cpu")
    with pytest.raises(ValueError):
        T.aslinearoperator(np.ones(3, np.float32), device="cpu")
    with pytest.raises(ValueError):
        T.aslinearoperator(tcore.build_tiles(tcore.csr_from_dense(spd64()),
                                             tcore.PartitionConfig(**CFG)),
                           strategy="bogus", device="cpu")


@pytest.mark.parametrize("form", ["csr", "dense", "diag"])
def test_jacobi_diagonal_equals_repro(form):
    A = badly_scaled_spd(32, np.random.default_rng(2))
    A[5, 5] = 0.0  # a zero diagonal entry falls back to scale 1
    arg = {"csr": lambda m: m.csr_from_dense(A), "dense": lambda m: A,
           "diag": lambda m: np.diagonal(A)}[form]
    want = np.asarray(J.jacobi(arg(jcore))(np.ones(32, np.float32)))
    M = T.jacobi(arg(tcore), device="cpu")
    assert np.array_equal(M(torch.ones(32)).numpy(), want)
    X = np.random.default_rng(3).standard_normal((32, 2)).astype(np.float32)
    assert np.array_equal(M(torch.as_tensor(X)).numpy(), np.asarray(J.jacobi(arg(jcore))(X)))
    with pytest.raises(ValueError):
        T.jacobi(np.ones((2, 2, 2), np.float32), device="cpu")


def test_hash_group_blocks_equal_repro():
    p = Pair(block_diag_dominant_spd(128, 8, np.random.default_rng(4)))
    jb, tb = J.hash_group_blocks(p.jtiles), T.hash_group_blocks(p.ttiles)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("partition", ["block_size", "hash_groups", "partial_cover"])
def test_block_jacobi_apply_matches_repro(partition):
    A = block_diag_dominant_spd(64, 8, np.random.default_rng(5))
    p = Pair(A)
    kw = {
        "block_size": lambda tiles, m: dict(block_size=8),
        "hash_groups": lambda tiles, m: dict(blocks=m.hash_group_blocks(tiles)),
        "partial_cover": lambda tiles, m: dict(blocks=[np.arange(0, 8), np.arange(16, 24)]),
    }[partition]
    Mj = J.block_jacobi(p.jcsr, **kw(p.jtiles, J))
    Mt = T.block_jacobi(p.tcsr, **kw(p.ttiles, T), device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal(64).astype(np.float32)
    X = rng.standard_normal((64, 3)).astype(np.float32)
    close_to(Mt(torch.as_tensor(x)), Mj(x), f"{partition} vector")
    close_to(Mt(torch.as_tensor(X)), Mj(X), f"{partition} block")


def test_block_jacobi_validation():
    csr = tcore.csr_from_dense(block_diag_dominant_spd(32, 8, np.random.default_rng(7)))
    with pytest.raises(ValueError, match="disjoint"):
        T.block_jacobi(csr, blocks=[np.arange(0, 8), np.arange(4, 12)], device="cpu")
    with pytest.raises(ValueError, match="outside"):
        T.block_jacobi(csr, blocks=[np.array([40])], device="cpu")
    with pytest.raises(TypeError, match="CSR"):
        T.block_jacobi(tcore.build_tiles(csr, tcore.PartitionConfig(**CFG)), device="cpu")


def test_transition_matrix_equals_repro():
    Mj, dj = J.transition_matrix(jmat.rmat(1 << 7, 600, seed=9, symmetric=False))
    Mt, dt = T.transition_matrix(tmat.rmat(1 << 7, 600, seed=9, symmetric=False))
    assert Mt.shape == Mj.shape
    for name in ("indptr", "indices", "data"):
        a, b = getattr(Mt, name), getattr(Mj, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert dt.dtype == dj.dtype and np.array_equal(dt, dj)


# --- CG ----------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cg_families_match_repro(family, strategy):
    p = Pair(spd_family(family))
    b = np.random.default_rng(10).standard_normal(128).astype(np.float32)
    opj, opt = p.ops(strategy)
    rj = J.cg(opj, b, tol=1e-7, maxiter=800)
    rt = T.cg(opt, b, tol=1e-7, maxiter=800)
    assert bool(rt.converged)
    same_solve(rt, rj, f"cg {family} {strategy}")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_cg_block_rhs_matches_repro(strategy):
    """Blocked-RHS CG: one SpMM per iteration, per-column step lengths."""
    p = Pair(spd64())
    B = np.random.default_rng(11).standard_normal((64, 4)).astype(np.float32)
    opj, opt = p.ops(strategy)
    rt = T.cg(opt, B, tol=1e-7, maxiter=500)
    assert rt.x.shape == (64, 4) and rt.history.shape == (501, 4)
    same_solve(rt, J.cg(opj, B, tol=1e-7, maxiter=500), f"cg k=4 {strategy}")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pcg_jacobi_matches_repro(strategy):
    """PCG with the diagonal captured at tile-build time (the registry's
    composition) on a badly scaled system; plain CG needs more steps."""
    A = badly_scaled_spd(96, np.random.default_rng(12))
    p = Pair(A)
    b = np.random.default_rng(13).standard_normal(96).astype(np.float32)
    opj, opt = p.ops(strategy)
    rj = J.cg(opj, b, tol=1e-6, maxiter=600, M=J.jacobi(p.jcsr.diagonal()))
    rt = T.cg(opt, b, tol=1e-6, maxiter=600, M=T.jacobi(p.tcsr.diagonal(), device="cpu"))
    assert bool(rt.converged)
    same_solve(rt, rj, f"pcg jacobi {strategy}")
    plain = T.cg(opt, b, tol=1e-6, maxiter=600)
    assert int(plain.iterations) > int(rt.iterations)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pcg_block_jacobi_hash_groups_matches_repro(strategy):
    """Block-Jacobi over the hash groups of the tiles: one dense
    [group, group] inverse per row group."""
    p = Pair(block_diag_dominant_spd(128, 8, np.random.default_rng(14)))
    b = np.random.default_rng(15).standard_normal(128).astype(np.float32)
    opj, opt = p.ops(strategy)
    Mj = J.block_jacobi(p.jcsr, blocks=J.hash_group_blocks(p.jtiles))
    Mt = T.block_jacobi(p.tcsr, blocks=T.hash_group_blocks(p.ttiles), device="cpu")
    rt = T.cg(opt, b, tol=1e-8, maxiter=400, M=Mt)
    assert bool(rt.converged)
    same_solve(rt, J.cg(opj, b, tol=1e-8, maxiter=400, M=Mj), f"pcg block-jacobi {strategy}")


def test_cg_zero_rhs_takes_no_step():
    p = Pair(spd64())
    opj, opt = p.ops("stable")
    b = np.zeros(64, np.float32)
    rt = T.cg(opt, b)
    assert int(rt.iterations) == 0 and bool(rt.converged)
    same_solve(rt, J.cg(opj, b), "cg b = 0")


# --- BiCGSTAB ------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [1, 3])
def test_bicgstab_matches_repro(k, strategy):
    n = 128
    A = jmat.circuit(n, seed=2, n_dense_rows=2, dense_row_frac=0.05).to_dense().astype(np.float32)
    N = (A + (np.abs(A).sum(axis=1).max() + 1) * np.eye(n, dtype=np.float32)).astype(np.float32)
    p = Pair(N)
    B = np.random.default_rng(16).standard_normal((n, k) if k > 1 else n).astype(np.float32)
    opj, opt = p.ops(strategy)
    rt = T.bicgstab(opt, B, tol=1e-7, maxiter=1000)
    assert bool(rt.converged)
    same_solve(rt, J.bicgstab(opj, B, tol=1e-7, maxiter=1000), f"bicgstab k={k} {strategy}")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_bicgstab_jacobi_matches_repro(strategy):
    """Right-preconditioned BiCGSTAB: on the shifted circuit matrix held
    like every solve; on a badly scaled nonsymmetric system (4 decades on
    each side, condition number 3.5e7, and no convergence in 800 steps
    without M) the count, the flag and x are held as everywhere, the
    history only to its NaN layout and its final entry: its intermediate
    residual norms are ill-determined in f32 (the JAX package's own CSR
    and tile paths differ by 1 % at step 3), while x is not."""
    n = 128
    A = jmat.circuit(n, seed=2, n_dense_rows=2, dense_row_frac=0.05).to_dense().astype(np.float32)
    p = Pair((A + (np.abs(A).sum(axis=1).max() + 1) * np.eye(n, dtype=np.float32)))
    b = np.random.default_rng(16).standard_normal(n).astype(np.float32)
    opj, opt = p.ops(strategy)
    rt = T.bicgstab(opt, b, tol=1e-7, maxiter=1000, M=T.jacobi(p.tcsr, device="cpu"))
    assert bool(rt.converged)
    same_solve(rt, J.bicgstab(opj, b, tol=1e-7, maxiter=1000, M=J.jacobi(p.jcsr)),
               f"bicgstab jacobi {strategy}")

    rng = np.random.default_rng(17)
    G = np.eye(n) + rng.standard_normal((n, n)) * 0.01
    s = 10.0 ** rng.uniform(-2, 2, n)
    p = Pair(((G * s).T * s).astype(np.float32))
    b = rng.standard_normal(n).astype(np.float32)
    opj, opt = p.ops(strategy)
    rt = T.bicgstab(opt, b, tol=1e-6, maxiter=800, M=T.jacobi(p.tcsr, device="cpu"))
    rj = J.bicgstab(opj, b, tol=1e-6, maxiter=800, M=J.jacobi(p.jcsr))
    assert bool(rt.converged) and int(rt.iterations) == int(rj.iterations)
    close_to(rt.x, rj.x, f"bicgstab jacobi scaled {strategy} x")
    hj, ht = np.asarray(rj.history), rt.history.numpy()
    assert np.array_equal(np.isnan(ht), np.isnan(hj))
    assert ht[int(rt.iterations)] == rt.residual.numpy() <= 1e-6 * np.linalg.norm(b)
    assert int(T.bicgstab(opt, b, tol=1e-6, maxiter=800).iterations) == 800


# --- Chebyshev -------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chebyshev_and_estimate_spectrum_match_repro(strategy):
    """estimate_spectrum's bounds within RTOL; with the JAX bounds on both
    sides, the fixed-degree smoothing pass (tol=0, exactly 30 steps) and a
    solve to tolerance with the exact bounds."""
    S = spd64()
    p = Pair(S)
    b = np.random.default_rng(18).standard_normal(64).astype(np.float32)
    opj, opt = p.ops(strategy)
    lo_j, hi_j = J.estimate_spectrum(opj)
    lo_t, hi_t = T.estimate_spectrum(opt)
    assert isinstance(hi_t, float)
    np.testing.assert_allclose([lo_t, hi_t], [lo_j, hi_j], rtol=RTOL)
    rt = T.chebyshev(opt, b, lam_min=lo_j, lam_max=hi_j, tol=0.0, maxiter=30)
    assert int(rt.iterations) == 30
    same_solve(rt, J.chebyshev(opj, b, lam_min=lo_j, lam_max=hi_j, tol=0.0, maxiter=30),
               f"chebyshev smoothing {strategy}")
    ev = np.linalg.eigvalsh(S.astype(np.float64))
    kw = dict(lam_min=float(ev[0]), lam_max=float(ev[-1]), tol=1e-6, maxiter=3000)
    rt = T.chebyshev(opt, b, **kw)
    assert bool(rt.converged)
    same_solve(rt, J.chebyshev(opj, b, **kw), f"chebyshev solve {strategy}")
    with pytest.raises(ValueError):
        T.chebyshev(opt, b, lam_min=2.0, lam_max=1.0)


# --- power iteration / PageRank -------------------------------------------------

# Cases whose exit iteration differs from the JAX package's by one.  The
# exit test compares ||A v - lam v|| with tol * |lam| = 1e-6 * lam: a
# difference of two f32 vectors of size lam, so at the exit its rounding
# noise is a few per cent of the threshold, and on these matrices the
# residual decays by only 1-2 % a step.  Which step first falls below is
# then decided by reduction order: the JAX package's own "fused" and
# "stable" paths exit at 166 and 165 on "rmat", 462 and 464 on
# "dense_block".  For these cases the test holds the count to one step
# and compares the recurrence itself at the JAX count (tol=0).
POWER_BORDERLINE = {
    ("rmat", "fused"), ("rmat", "partials"),
    ("dense_block", "fused"), ("dense_block", "partials"), ("dense_block", "stable"),
}


def same_eig(rt, rj, what):
    close_to(rt.eigenvalue, rj.eigenvalue, f"{what} eigenvalue")
    close_to(rt.eigenvector, rj.eigenvector, f"{what} eigenvector")
    close_to(rt.history, rj.history, f"{what} history")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_power_iteration_matches_repro(family, strategy):
    p = Pair(spd_family(family))
    opj, opt = p.ops(strategy)
    rj = J.power_iteration(opj, tol=1e-6, maxiter=3000)
    rt = T.power_iteration(opt, tol=1e-6, maxiter=3000)
    assert bool(rt.converged) and bool(rj.converged)
    it_j, it_t = int(rj.iterations), int(rt.iterations)
    what = f"power {family} {strategy}"
    if (family, strategy) in POWER_BORDERLINE:
        assert abs(it_t - it_j) == 1, (what, it_t, it_j)
        rt = T.power_iteration(opt, tol=0.0, maxiter=it_j)
        rj = J.power_iteration(opj, tol=0.0, maxiter=it_j)
    else:
        assert it_t == it_j, (what, it_t, it_j)
    same_eig(rt, rj, what)
    lam_ref = float(np.linalg.eigvalsh(spd_family(family).astype(np.float64))[-1])
    assert abs(float(rt.eigenvalue) - lam_ref) / lam_ref < 1e-5


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [1, 4])
def test_pagerank_matches_repro(k, strategy):
    """k = 1 with the uniform teleport, k = 4 personalization columns in
    one SpMM per step.  At the solver's default tol=1e-8 (the L1 change
    under n * tol = 1.3e-6); at the JAX tests' 1e-10 the threshold sits at
    f32's floor for the L1 change of a 128-node ranking, and exits are
    rounding noise (the JAX package's own fused and stable paths then stop
    at 300 and 21 steps at k = 4)."""
    Mj, dj = J.transition_matrix(jmat.rmat(1 << 7, 600, seed=9, symmetric=False))
    Mt, dt = T.transition_matrix(tmat.rmat(1 << 7, 600, seed=9, symmetric=False))
    p = Pair(jcsr=Mj, tcsr=Mt)
    opj, opt = p.ops(strategy)
    P = None
    if k > 1:
        P = np.random.default_rng(19).random((128, k)).astype(np.float32) + 0.01
    rj = J.pagerank(opj, personalization=P, dangling=dj, maxiter=300)
    rt = T.pagerank(opt, personalization=P, dangling=dt, maxiter=300)
    assert bool(rt.converged)
    assert np.isinf(rt.history[0].numpy()).all()
    same_solve(rt, rj, f"pagerank k={k} {strategy}")
    np.testing.assert_allclose(rt.x.sum(0).numpy(), np.ones(k).squeeze(), atol=1e-5)


# --- the solver loop, history and telemetry ----------------------------------------


def _solves():
    """One run of each solver on the port (stable), as callables."""
    S = spd64()
    p = Pair(S)
    _, op = p.ops("stable")
    b = np.random.default_rng(20).standard_normal(64).astype(np.float32)
    B = np.random.default_rng(21).standard_normal((64, 3)).astype(np.float32)
    Mt, dt = T.transition_matrix(tmat.rmat(1 << 7, 600, seed=9, symmetric=False))
    pr = T.aslinearoperator(tcore.build_tiles(Mt, tcore.PartitionConfig(**CFG)),
                            strategy="stable", device="cpu")
    M = T.jacobi(p.tcsr, device="cpu")
    P = np.random.default_rng(22).random((128, 3)).astype(np.float32) + 0.01
    return {
        "cg": lambda: T.cg(op, B, tol=1e-7, maxiter=500, M=M),
        "bicgstab": lambda: T.bicgstab(op, b, tol=1e-7, maxiter=500, M=M),
        "chebyshev": lambda: T.chebyshev(op, b, lam_min=0.3, lam_max=3.5, tol=1e-6, maxiter=300),
        "power_iteration": lambda: T.power_iteration(op, tol=1e-6, maxiter=300),
        "pagerank": lambda: T.pagerank(pr, dangling=dt, personalization=P),
    }


def _fields(res):
    return [t.clone() for t in res]


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "chebyshev", "power_iteration",
                                    "pagerank"])
def test_check_every_one_is_bitwise_the_default(solver, monkeypatch):
    """Reading the flag after every step, after every third, and at the
    default CHECK_EVERY gives the same bits: masked steps keep the state."""
    run = _solves()[solver]
    default = _fields(run())
    for every in (1, 3):
        monkeypatch.setattr(tbase, "CHECK_EVERY", every)
        again = _fields(run())
        for a, b in zip(again, default):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.is_floating_point():  # bit patterns: NaN and -0.0 too
                a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)
            assert torch.equal(a, b), (solver, every)


def test_loop_reads_the_flag_once_per_chunk(monkeypatch):
    """The host reads the convergence flag before the first chunk and after
    each chunk; a chunk of CHECK_EVERY steps runs with no read, and the
    count stops where lax.while_loop stops."""
    chunks = []
    orig = tbase._chunk

    def counting(cond, body, k, state, active, steps):
        chunks.append(steps)
        return orig(cond, body, k, state, active, steps)

    monkeypatch.setattr(tbase, "_chunk", counting)
    # converges at step 3: one chunk of CHECK_EVERY, 3 live steps
    state = (torch.tensor(10.0),)
    k, (v,) = tbase.while_loop(lambda s: s[0] > 7.5, lambda k, s: (s[0] - 1,), state, 100)
    assert int(k) == 3 and float(v) == 7.0 and chunks == [tbase.CHECK_EVERY]
    # maxiter cuts the last chunk short, and no flag is read after it
    chunks.clear()
    k, (v,) = tbase.while_loop(lambda s: s[0] > -1e9, lambda k, s: (s[0] - 1,), state, 11)
    assert int(k) == 11 and float(v) == -1.0
    assert chunks == [tbase.CHECK_EVERY, 11 - tbase.CHECK_EVERY]
    chunks.clear()
    k, _ = tbase.while_loop(lambda s: s[0] > 100, lambda k, s: (s[0] - 1,), state, 11)
    assert int(k) == 0 and chunks == []


def test_history_set_clamps_and_leaves_one_slot():
    hist = tbase.history_init(2, torch.tensor(5.0))
    assert torch.isnan(hist[1:]).all() and float(hist[0]) == 5.0
    h = tbase.history_set(hist, torch.tensor(1), torch.tensor(4.0))
    assert h[1] == 4.0 and torch.isnan(hist[1])  # out of place
    # past the end: the last slot (only a masked step, whose state the
    # loop discards, asks for one)
    assert tbase.history_set(hist, torch.tensor(3), torch.tensor(4.0))[2] == 4.0
    lean = tbase.history_init(0, torch.tensor(5.0))
    assert tbase.history_set(lean, torch.tensor(1), torch.tensor(4.0)) is lean


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "chebyshev"])
def test_record_history_false_single_slot_same_solution(solver):
    S = spd64()
    _, op = Pair(S).ops("stable")
    b = np.random.default_rng(22).standard_normal(64).astype(np.float32)
    fn = {
        "cg": lambda **kw: T.cg(op, b, tol=1e-7, maxiter=500, **kw),
        "bicgstab": lambda **kw: T.bicgstab(op, b, tol=1e-7, maxiter=500, **kw),
        "chebyshev": lambda **kw: T.chebyshev(op, b, lam_min=0.3, lam_max=3.5, tol=0.0,
                                              maxiter=30, **kw),
    }[solver]
    full, lean = fn(), fn(record_history=False)
    assert lean.history.shape == (1,) and full.history.shape[0] > 1
    assert int(lean.iterations) == int(full.iterations)
    assert torch.equal(lean.x, full.x)
    assert torch.equal(lean.history[0], full.history[0])


def test_record_history_streams_to_obs():
    """With obs enabled the history lands as solver.runs and the residual
    series; record_history=False keeps the stream silent; the flight ring
    gets one solver.run instant per recorded solve, obs on or off."""
    S = spd64()
    _, op = Pair(S).ops("stable")
    b = np.random.default_rng(23).standard_normal(64).astype(np.float32)
    tobs.reset()
    tobs.enable()
    try:
        res = T.cg(op, b, tol=1e-7, maxiter=500)
        T.cg(op, b, tol=1e-7, maxiter=500, record_history=False)
        assert tobs.registry().value("solver.runs", 0, solver="cg") == 1
        (s,) = tobs.registry().find("solver.cg.residual")
        assert len(s.points) == int(res.iterations) + 1
        np.testing.assert_array_equal(
            np.asarray(s.values, np.float32), res.history[: int(res.iterations) + 1].numpy())
        runs = [e for e in tobs.flight().snapshot() if e.get("name") == "solver.run"]
        assert len(runs) == 1 and runs[0]["args"]["iters"] == int(res.iterations)
    finally:
        tobs.disable()
        tobs.reset()


# --- registry and the autotune probe ---------------------------------------------


def test_registry_plan_composes_with_solvers(tmp_path):
    """plan.operator()/plan.jacobi() against the JAX package's
    test_registry_plan_composes_with_solvers, the same matrix and b."""
    rng = np.random.default_rng(0)
    n = 96
    R = rng.standard_normal((n, n)) * 0.02
    S = (np.eye(n) + R @ R.T).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jplan = jserving.MatrixRegistry(cache_dir=tmp_path / "j", search=False).admit(
        jcore.csr_from_dense(S), "spd")
    treg = tserving.MatrixRegistry(device="cpu", cache_dir=tmp_path / "t", search=False)
    tplan = treg.admit(tcore.csr_from_dense(S), "spd")
    assert tplan.cfg.__dict__ == jplan.cfg.__dict__ and tplan.strategy == jplan.strategy
    rj = J.cg(jplan.operator(), b, tol=1e-6, maxiter=300, M=jplan.jacobi())
    rt = T.cg(tplan.operator(), b, tol=1e-6, maxiter=300, M=tplan.jacobi())
    assert bool(rt.converged)
    same_solve(rt, rj, "registry cg")
    x_ref = np.linalg.solve(S.astype(np.float64), b)
    assert np.abs(rt.x.numpy() - x_ref).max() / np.abs(x_ref).max() < 1e-4
    # the plan's operator is the tiles' operator under the plan's strategy
    op = T.aslinearoperator(tplan.tiles, strategy=tplan.strategy, device="cpu")
    x = torch.as_tensor(b)
    assert torch.equal(tplan.operator()(x), op(x))


CANDIDATES = [
    dict(row_block=64, col_block=128, group=8, lane=8),
    dict(row_block=64, col_block=256, group=8, lane=16),
    dict(row_block=128, col_block=128, group=8, lane=32),
]


@pytest.fixture()
def probe_csr():
    return tmat.circuit(400, seed=2)


def _tune(csr, cache, **kw):
    return tserving.autotune_partition(
        csr, cache=cache, candidates=[tcore.PartitionConfig(**c) for c in CANDIDATES],
        repeats=1, device="cpu", **kw)


def test_cg_probe_searches_and_caches(tmp_path, probe_csr):
    """A fixed-iteration CG run per candidate, cached like any search."""
    cache = tserving.AutotuneCache(tmp_path / "cache")
    probe = tserving.cg_probe(iters=3, device="cpu")
    assert probe.kind == "cg3x1_stable" and probe.params == ("cpu",)
    res = _tune(probe_csr, cache, probe=probe)
    assert res.searched and res.evaluations == len(CANDIDATES)
    assert res.objective_us is not None and res.objective_us > 0
    again = _tune(probe_csr, cache, probe=probe)
    assert again.cache_hit and again.cfg == res.cfg
    assert tserving.cg_probe(iters=3, k=4, strategy="partials", device="cpu").kind == (
        "cg3x4_partials")
    with pytest.raises(ValueError):
        tserving.cg_probe(strategy="bogus", device="cpu")


def test_probe_kind_fingerprints_cache_entries(tmp_path, probe_csr, monkeypatch):
    """An entry searched under one objective never satisfies an admission
    searching under another: the probe's kind and params (the device
    type) are part of the fingerprint."""
    cache = tserving.AutotuneCache(tmp_path / "cache")
    assert _tune(probe_csr, cache).searched
    solver = _tune(probe_csr, cache, probe=tserving.cg_probe(iters=3, device="cpu"))
    assert solver.searched and not solver.cache_hit  # the spmm entry did not satisfy
    assert _tune(probe_csr, cache, probe=tserving.cg_probe(iters=3, device="cpu")).cache_hit
    assert _tune(probe_csr, cache).searched
    assert (tserving.cg_probe(iters=3, device="cpu").kind
            != tserving.cg_probe(iters=10, device="cpu").kind)
    # the same solve on the card is another objective (nothing is measured)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    on_card = tserving.cg_probe(iters=3, strategy="stable", device="cuda")
    assert on_card.kind == "cg3x1_stable" and on_card.params == ("cuda",)
    assert tserving.cg_probe(iters=3, device="cuda").kind == "cg3x1_fused"
