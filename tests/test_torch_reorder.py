"""The port's sparse front end against the JAX package.

``sparse.py`` and ``reorder.py`` are numpy copies of the JAX package's
modules, so their results must be exactly equal: the generator, the CSR
containers, DB, CM, drop-off, band assembly and the whole ``analyze``.  The ``CsrOperator`` matvec (gather + ``index_add_``)
agrees with the JAX ``segment_sum`` matvec to float32 rounding: the same
products summed in another order, at most 1e-6 of the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jop
from repro.core import reorder as jro
from repro.core import sparse as jsp
import repro_torch.core as T
from repro_torch.core import operators as top
from repro_torch.core import reorder as tro
from repro_torch.core import sparse as tsp


def _port(csr):
    """The same matrix as the port's own CSR container."""
    return tsp.CSR(indptr=csr.indptr, indices=csr.indices, data=csr.data, n=csr.n)


def _equal_csr(a, b):
    assert a.n == b.n
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


MATRICES = [
    # n, avg nnz per row, d, structured band, shuffle
    (60, 6.0, 1.0, None, True),
    (200, 10.0, 0.5, 8, True),
    (150, 4.0, 2.0, 5, False),
]


@pytest.mark.parametrize("n,nnz,d,band,shuffle", MATRICES)
def test_random_sparse_is_bit_equal(n, nnz, d, band, shuffle):
    kw = dict(d=d, shuffle=shuffle, seed=n, structured_band=band)
    _equal_csr(tsp.random_sparse(n, nnz, **kw), jsp.random_sparse(n, nnz, **kw))


def test_csr_containers_are_equal():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(30, 30)) * (rng.random((30, 30)) < 0.2)
    _equal_csr(tsp.csr_from_dense(a), jsp.csr_from_dense(a))
    rows, cols = rng.integers(0, 30, 80), rng.integers(0, 30, 80)
    vals = rng.normal(size=80)
    t, j = tsp.csr_from_coo(30, rows, cols, vals), jsp.csr_from_coo(30, rows, cols, vals)
    _equal_csr(t, j)
    _equal_csr(t.transpose(), j.transpose())
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())


@pytest.mark.parametrize("use_db", [True, False])
@pytest.mark.parametrize("use_cm", [True, False])
@pytest.mark.parametrize("drop_tol", [0.0, 0.05])
def test_analyze_is_exactly_equal(use_db, use_cm, drop_tol):
    csr = jsp.random_sparse(300, 8.0, d=1.0, seed=3, structured_band=10)
    kw = dict(use_db=use_db, use_cm=use_cm, drop_tol=drop_tol)
    t, j = tro.analyze(_port(csr), **kw), jro.analyze(csr, **kw)
    np.testing.assert_array_equal(t.b_perm, j.b_perm)
    np.testing.assert_array_equal(t.x_perm, j.x_perm)
    assert t.k == j.k
    np.testing.assert_array_equal(t.band_pc, j.band_pc)
    assert t.info == j.info
    _equal_csr(t.csr, j.csr)


def test_analyze_takes_dense_and_scipy_input():
    csr = jsp.random_sparse(80, 6.0, d=1.0, seed=5)
    dense = csr.to_dense()
    t, j = tro.analyze(dense), jro.analyze(dense)
    np.testing.assert_array_equal(t.b_perm, j.b_perm)
    assert t.k == j.k
    scipy = pytest.importorskip("scipy.sparse")
    m = scipy.csr_matrix(dense)
    np.testing.assert_array_equal(tro.analyze(m).band_pc, jro.analyze(m).band_pc)


def test_reorder_stages_are_equal():
    csr = jsp.random_sparse(120, 6.0, d=0.7, seed=2, structured_band=6)
    tcsr = _port(csr)
    np.testing.assert_array_equal(tro.diagonal_boosting(tcsr), jro.diagonal_boosting(csr))
    for t, j in zip(tro.diagonal_boosting(tcsr, return_scaling=True),
                    jro.diagonal_boosting(csr, return_scaling=True)):
        np.testing.assert_array_equal(t, j)
    sym = jro.symmetrize(csr)
    _equal_csr(tro.symmetrize(tcsr), sym)
    np.testing.assert_array_equal(tro.cuthill_mckee(_port(sym)), jro.cuthill_mckee(sym))
    np.testing.assert_array_equal(tro.cuthill_mckee(_port(sym), reverse=True),
                                  jro.cuthill_mckee(sym, reverse=True))
    perm = np.random.default_rng(1).permutation(120)
    _equal_csr(tro.permute_rows(tcsr, perm), jro.permute_rows(csr, perm))
    _equal_csr(tro.permute_symmetric(tcsr, perm), jro.permute_symmetric(csr, perm))
    assert tro.half_bandwidth(tcsr) == jro.half_bandwidth(csr)
    t, j = tro.drop_off(tcsr, 0.1), jro.drop_off(csr, 0.1)
    _equal_csr(t[0], j[0])
    assert t[1] == j[1]
    k = jro.half_bandwidth(csr)
    band = jro.csr_to_band(csr, k)
    np.testing.assert_array_equal(tro.csr_to_band(tcsr, k), band)


@pytest.mark.parametrize("shape", [(200,), (200, 3)])
def test_csr_operator_matvec_matches_jax(shape):
    csr = jsp.random_sparse(200, 10.0, d=1.0, seed=7)
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    t = top.CsrOperator.from_csr(_port(csr), device="cpu")
    j = jop.CsrOperator.from_csr(csr)
    assert t.dtype == torch.float32 and t.n == j.n == 200
    got, want = t.matvec(torch.tensor(x)).numpy(), np.asarray(j.matvec(jnp.asarray(x)))
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # float64 iterate: the float32-stored values are cast to the iterate
    got64 = t.matvec(torch.tensor(x, dtype=torch.float64))
    assert got64.dtype == torch.float64
    assert np.abs(got64.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_csr_operator_round_trips_to_csr():
    csr = tsp.random_sparse(50, 5.0, d=1.0, seed=1)
    op = top.CsrOperator.from_csr(csr, dtype=torch.float64, device="cpu")
    _equal_csr(op.to_csr(), csr)


def test_require_square_dense_and_as_operator():
    with pytest.raises(TypeError, match="square"):
        top.require_square_dense(np.zeros((10, 5)))
    top.require_square_dense(np.zeros((4, 4)))
    dense = tsp.random_sparse(40, 5.0, d=1.0, seed=2).to_dense()
    op = top.as_operator(torch.tensor(dense), device="cpu")
    assert isinstance(op, T.CsrOperator)
    x = np.ones(40)
    np.testing.assert_allclose(op.matvec(torch.tensor(x)).numpy(), dense @ x, rtol=1e-6)
    assert top.as_operator(op) is op
    assert top.as_matvec(op) == op.matvec
    with pytest.raises(TypeError):
        top.as_operator(np.zeros((10, 21)), device="cpu")
