"""The port's SpMV front door and argmax SpMM against the JAX package's.

``repro_torch.core.spmv`` dispatches on the same containers as
``repro.core.spmv``: the numpy paths (CSR reference, the Algorithm 3
``HBPMatrix``) must give equal arrays; the device paths (torch's
sparse-CSR product, the port's ``"auto"`` for a CSR matrix, against the
JAX segment sum or numpy product, the HBP tiles through the
port's kernels' plain versions against the JAX Pallas kernel in interpret
mode or its jnp oracle) agree within ``rtol=1e-5, atol=1e-5 * max(1,
|y|_inf)``, since the two reduce in different orders.

``ops.hbp_spmm_argmax`` must equal the JAX package's bit for bit, under
one and three passes: values (the max is exact), winning columns (ties to
the lowest column), coefficients and the empty-row conventions.  Both run
on exactly the same tiles (the JAX build carried over) and the same x.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch.kernels import ops as tops

from hub_runs import ZERO_CONFIG, signed_zero_coo

FIELDS = ("data", "cols", "rowgroup", "colblock", "first", "perm")


def _close(y_port, y_jax):
    y_jax = np.asarray(y_jax)
    atol = 1e-5 * max(1.0, float(np.abs(y_jax).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(y_port), y_jax, rtol=1e-5, atol=atol)


def _bits(a):
    """Bit patterns, NaN payloads folded: the contract is NaN's position."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32)
        return a.view(np.int32)
    return a


def _carry(tj):
    """The JAX package's tiles as the port's host tiles (same arrays)."""
    d = {f: getattr(tj, f) for f in FIELDS}
    d.update(shape=tj.shape, n_rowgroups=tj.n_rowgroups, cfg=dataclasses.asdict(tj.cfg))
    return tcore.tiles_from_arrays(d)


def _dense(seed, n_rows=70, n_cols=90, density=0.2, zero_rows=None):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n_rows, n_cols)) * (rng.random((n_rows, n_cols)) < density)
    if zero_rows is not None:
        dense[zero_rows] = 0.0
    return dense.astype(np.float32)


@pytest.fixture(scope="module")
def matrix():
    """One matrix as every container of both packages."""
    dense = _dense(0, zero_rows=slice(30, 40))
    cj, ct = jcore.csr_from_dense(dense), tcore.csr_from_dense(dense)
    cfg = dict(row_block=32, col_block=32, group=8, lane=8)
    tj = jcore.build_tiles(cj, jcore.PartitionConfig(**cfg))
    return dict(
        dense=dense,
        csr=(cj, ct),
        hbp=(jcore.build_hbp(cj), tcore.build_hbp(ct)),
        tiles=(tj, _carry(tj)),
    )


def _rhs(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (n, k)).astype(np.float32)


# (container, port backend, JAX backend, exact): the numpy paths are equal
FRONT_DOOR = [
    ("csr", "auto", "auto", False),  # on the device here, numpy in JAX
    ("csr", "reference", "reference", True),
    ("csr", "torch", "jnp", False),
    ("csr", "cuda", "pallas", False),
    ("hbp", "auto", "auto", True),
    ("tiles", "auto", "auto", False),
    ("tiles", "cuda", "pallas", False),
    ("tiles", "torch", "jnp", False),
]


@pytest.mark.parametrize("k", [None, 1, 3], ids=["vector", "column", "k3"])
@pytest.mark.parametrize("kind,backend,jax_backend,exact", FRONT_DOOR)
def test_front_door_matches_jax(matrix, kind, backend, jax_backend, exact, k):
    a_j, a_t = matrix[kind]
    x = _rhs(matrix["dense"].shape[1], k)
    kw = dict(interpret=True) if kind == "tiles" else {}
    y_j = jcore.spmv(a_j, x, backend=jax_backend, **kw)
    y_t = tcore.spmv(a_t, x, backend=backend, device="cpu")
    # the [n, 1] shape rule: a column stays a column
    assert tuple(np.shape(y_t)) == tuple(np.shape(y_j))
    assert np.shape(y_t) == ((70,) if k is None else (70, k))
    if exact:
        assert isinstance(y_t, np.ndarray)
        np.testing.assert_array_equal(y_t, np.asarray(y_j))
    else:
        assert isinstance(y_t, torch.Tensor) and y_t.device.type == "cpu"
        _close(y_t, y_j)
    if k is not None:  # spmm is the same product
        y_mm = tcore.spmm(a_t, x, backend=backend, device="cpu")
        np.testing.assert_array_equal(np.asarray(y_mm), np.asarray(y_t))
    _close(np.asarray(y_t), matrix["dense"] @ x)


def test_front_door_shape_rules_and_errors(matrix):
    _, ct = matrix["csr"]
    _, tt = matrix["tiles"]
    with pytest.raises(ValueError, match="1-D or 2-D"):
        tcore.spmv(ct, np.zeros((90, 1, 1), np.float32))
    with pytest.raises(ValueError, match="use spmv"):
        tcore.spmm(ct, np.zeros(90, np.float32))
    with pytest.raises(ValueError, match="unsupported backend"):
        tcore.spmv(tt, np.zeros(90, np.float32), backend="reference", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.spmv(ct, np.zeros(90, np.float32), backend="pallas")
    with pytest.raises(TypeError, match="unsupported matrix type"):
        tcore.spmv(matrix["dense"], np.zeros(90, np.float32))
    # a nested list dispatches by its rank, as in the JAX package
    col = np.ones((90, 1), np.float32).tolist()
    assert np.shape(tcore.spmv(ct, col, device="cpu")) == (70, 1)
    assert np.shape(tcore.spmv(ct, col, backend="reference")) == (70, 1)


def test_front_door_defaults_to_the_card(matrix, monkeypatch):
    _, ct = matrix["csr"]
    _, tt = matrix["tiles"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones(90, np.float32)
    for a, backend in ((ct, "auto"), (ct, "torch"), (ct, "cuda"), (tt, "auto"),
                       (tt, "torch")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcore.spmv(a, x, backend=backend)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcore.spmm(a, x[:, None], backend=backend)
    # the numpy references need no device, and take a tensor's values
    assert isinstance(tcore.spmv(ct, x, backend="reference"), np.ndarray)
    _, ht = matrix["hbp"]
    y = tcore.spmv(ht, torch.as_tensor(x))
    np.testing.assert_array_equal(y, tcore.spmv(ht, x))


def test_hbp_reference_equals_jax_format(matrix):
    hj, ht = matrix["hbp"]
    for field in ("col", "data", "add_sign", "zero_row", "begin_nnz", "group_ptr",
                  "output_hash", "group_nnz_rows"):
        np.testing.assert_array_equal(getattr(ht, field), getattr(hj, field))


# --- the argmax SpMM -----------------------------------------------------


def _argmax_pair(dense, lane, **geometry):
    geometry = geometry or dict(row_block=32, col_block=32, group=8)
    tj = jcore.build_tiles(jcore.csr_from_dense(dense),
                           jcore.PartitionConfig(**{**geometry, "lane": lane}))
    return tj, tops.device_tiles(_carry(tj), "cpu")


def _same_triple(got, want):
    for name, a, b in zip(("y", "idx", "coeff"), got, want):
        a = a.numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


ARGMAX_CASES = {
    # gaussian x over a gaussian matrix with empty row groups
    "gaussian": lambda: (_dense(2, zero_rows=slice(16, 48)), None),
    # a binary matrix and small integer x: many tied products
    "ties": lambda: ((_dense(3) != 0).astype(np.float32), "int"),
    # NaN in x rows that live slots read
    "nan": lambda: (_dense(4), "nan"),
}


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("lane", [4, 8])
@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_argmax_matches_jax_bit_for_bit(case, lane, k, passes):
    dense, kind = ARGMAX_CASES[case]()
    tj, dt = _argmax_pair(dense, lane)
    rng = np.random.default_rng(k + lane)
    X = rng.standard_normal((dense.shape[1], k)).astype(np.float32)
    if kind == "int":
        X = rng.integers(-2, 3, (dense.shape[1], k)).astype(np.float32)
    elif kind == "nan":
        X[[3, 50]] = np.nan
    got = tops.hbp_spmm_argmax(dt, X, passes=passes)
    want = jops.hbp_spmm_argmax(tj, X, passes=passes)
    _same_triple(got, want)
    y, idx, coeff = got
    # y is the max SpMM's, bit for bit
    y_max = tops.hbp_spmm(dt, X, strategy="stable", combine="max")
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(y_max.numpy()))
    # empty rows: no winner, no coefficient, output 0
    empty = ~dense.any(axis=1)
    if empty.any():
        assert np.all(idx.numpy()[empty] == -1) and np.all(coeff.numpy()[empty] == 0)
        assert np.all(y.numpy()[empty] == 0)
    live = idx.numpy() >= 0
    rows = np.nonzero(live)[0]
    np.testing.assert_array_equal(coeff.numpy()[live], dense[rows, idx.numpy()[live]])


def test_argmax_one_and_three_passes_agree_on_the_tied_case():
    dense = np.zeros((3, 3), np.float32)
    dense[0, 1] = dense[0, 2] = 2.0  # row 0 aggregates columns 1 and 2 equally
    tj, dt = _argmax_pair(dense, 2, row_block=4, col_block=4, group=2)
    X = np.full((3, 2), 3.0, np.float32)  # columns 1 and 2 tie at 6.0
    for passes in (1, 3):
        y, idx, coeff = tops.hbp_spmm_argmax(dt, X, passes=passes)
        assert y[0].tolist() == [6.0, 6.0] and idx[0].tolist() == [1, 1]
        assert coeff[0].tolist() == [2.0, 2.0]
        assert idx[1].tolist() == [-1, -1] and coeff[2].tolist() == [0.0, 0.0]
        _same_triple((y, idx, coeff), jops.hbp_spmm_argmax(tj, X, passes=passes))


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("sign", [0.0, -0.0], ids=["x+0", "x-0"])
def test_argmax_signed_zero_ties(sign, passes):
    """``±0`` products compare equal in the tie-break (the lowest column
    wins) while the value chain ranks ``+0.0`` above ``-0.0``."""
    rows, cols, vals, shape, want = signed_zero_coo()
    csr = jcore.csr_from_coo(jcore.COOMatrix(rows, cols, vals, shape))
    tj = jcore.build_tiles(csr, jcore.PartitionConfig(**ZERO_CONFIG))
    dt = tops.device_tiles(_carry(tj), "cpu")
    X = np.full((shape[1], 3), sign, np.float32)
    got = tops.hbp_spmm_argmax(dt, X, passes=passes)
    _same_triple(got, jops.hbp_spmm_argmax(tj, X, passes=passes))
    y, idx, _ = got
    expect = np.zeros_like(want) if np.signbit(sign) else want  # -1 * -0 = +0
    np.testing.assert_array_equal(y.numpy()[:, 0].view(np.int32), expect.view(np.int32))
    # the lowest column of each row wins, whatever the signs
    first = [3, 3, 0, 0, 7, 1, 2]
    assert idx.numpy()[:7, 0].tolist() == first


def test_argmax_validation_and_empty_matrix():
    dense = _dense(5)
    _, dt = _argmax_pair(dense, 8)
    with pytest.raises(ValueError, match="passes"):
        tops.hbp_spmm_argmax(dt, np.zeros((90, 2), np.float32), passes=2)
    with pytest.raises(ValueError, match=r"\[n_cols, k\]"):
        tops.hbp_spmm_argmax(dt, np.zeros(90, np.float32))
    _, empty = _argmax_pair(np.zeros((40, 20), np.float32), 8)
    y, idx, coeff = tops.hbp_spmm_argmax(empty, np.ones((20, 3), np.float32))
    assert y.shape == (40, 3) and torch.all(y == 0) and torch.all(idx == -1)
    assert idx.dtype == torch.int32 and torch.all(coeff == 0)
