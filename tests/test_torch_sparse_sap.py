"""The port's sparse lifecycle against the JAX package.

``factor(plan(a, opts)).solve(b)``, ``solve_many`` and ``solve_sparse`` on
both packages, for CSR, scipy and dense square input, float32 throughout
(JAX x64 off).  The plans must be identical (the host analysis is a
copy); the answers are compared as in ``test_torch_sap.py``:

* x: normwise relative difference to the JAX x at most 1e-4 -- float32
  Krylov iterations whose sums run in another order;
* true_resnorm: both at most 10 * tol;
* iterations: equal or within one sweep.
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch as RT
import repro_torch.core as T
from repro.core import sparse as jsp
from repro_torch.core import sparse as tsp

TOL = 1e-6

MATRICES = {
    # name: (n, avg nnz per row, d, structured band)
    "d1": (240, 8.0, 1.0, 6),
    "d07": (200, 6.0, 0.7, 5),
}


@functools.lru_cache(maxsize=None)
def _system(name, nrhs=None):
    """(the JAX package's CSR, the port's CSR of the same matrix, b)."""
    n, nnz, d, band = MATRICES[name]
    csr = jsp.random_sparse(n, nnz, d=d, seed=n, structured_band=band)
    # float32-exact values, so the float32 operator is the matrix solved
    csr.data = csr.data.astype(np.float32).astype(np.float64)
    tcsr = tsp.CSR(indptr=csr.indptr, indices=csr.indices, data=csr.data, n=csr.n)
    rng = np.random.default_rng(n + 1)
    xstar = rng.normal(size=(n,) if nrhs is None else (n, nrhs))
    return csr, tcsr, (csr.to_dense() @ xstar).astype(np.float32)


def _compare(tres, jres):
    tx, jx = tres.x.numpy(), np.asarray(jres.x)
    assert tx.shape == jx.shape
    assert np.linalg.norm(tx - jx, axis=0).max() <= 1e-4 * np.linalg.norm(jx, axis=0).min()
    assert np.max(tres.true_resnorm.numpy()) <= 10 * TOL
    assert np.max(np.asarray(jres.true_resnorm)) <= 10 * TOL
    assert np.abs(tres.iterations.numpy() - np.asarray(jres.iterations)).max() <= 1.0


CASES = [
    # name, options
    ("d1", dict(p=4, variant="C")),
    ("d1", dict(p=4, variant="D", use_db=False)),
    ("d1", dict(p=4, variant="C", use_cm=False)),
    ("d07", dict(p=4, variant="auto")),
    ("d07", dict(p=10, variant="E")),  # 9 interfaces: BCR
    ("d1", dict(p=4, variant="C", drop_tol=0.01)),
]


@functools.lru_cache(maxsize=None)
def _pair(name, items):
    csr, tcsr, _ = _system(name)
    kw = dict(items, tol=TOL, maxiter=300)
    jplan = J.plan(csr, J.SaPOptions(**kw))
    tplan = RT.plan(tcsr, T.SaPOptions(**kw), device="cpu")
    return jplan, tplan, J.factor(jplan), RT.factor(tplan)


@pytest.mark.parametrize("name,opts", CASES)
def test_plan_matches_jax(name, opts):
    jplan, tplan, _, _ = _pair(name, tuple(opts.items()))
    np.testing.assert_array_equal(tplan.b_perm, jplan.b_perm)
    np.testing.assert_array_equal(tplan.x_perm, jplan.x_perm)
    assert (tplan.k, tplan.n) == (jplan.k, jplan.n)
    assert tplan.info == jplan.info
    assert tplan.band_pc.dtype == torch.float32
    np.testing.assert_array_equal(tplan.band_pc.numpy(), np.asarray(jplan.band_pc))
    assert isinstance(tplan.op, T.CsrOperator)
    np.testing.assert_array_equal(tplan.op.data.numpy(), np.asarray(jplan.op.data))


@pytest.mark.parametrize("name,opts", CASES)
def test_sparse_solve_matches_jax(name, opts):
    _, _, jfac, tfac = _pair(name, tuple(opts.items()))
    assert (tfac.variant, tfac.p, tfac.n_pad) == (jfac.variant, jfac.p, jfac.n_pad)
    assert tfac.pc.reduced_solver == jfac.pc.reduced_solver
    _, _, b = _system(name)
    _compare(tfac.solve(b), jfac.solve(jnp.asarray(b)))


@pytest.mark.parametrize("name,opts", CASES[:1] + CASES[4:5])
def test_sparse_solve_many_matches_jax(name, opts):
    _, _, jfac, tfac = _pair(name, tuple(opts.items()))
    _, _, bmat = _system(name, nrhs=3)
    tres = tfac.solve_many(bmat)
    _compare(tres, jfac.solve_many(jnp.asarray(bmat)))
    one = tfac.solve(bmat[:, 2])
    assert torch.allclose(one.x, tres.x[:, 2], rtol=1e-4, atol=1e-5)


def test_the_answer_is_in_the_original_ordering():
    """The permutations are undone: A x = b in the caller's ordering."""
    _, csr, b = _system("d1")
    res = RT.factor(RT.plan(csr, T.SaPOptions(p=4, tol=1e-8), device="cpu")).solve(b.astype(np.float64))
    resid = csr.to_dense() @ res.x.numpy() - b
    assert np.linalg.norm(resid) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("kind", ["dense", "tensor", "scipy", "operator"])
def test_plan_takes_dense_scipy_and_operator_input(kind):
    csr, tcsr, b = _system("d1")
    opts = T.SaPOptions(p=4, variant="C", tol=TOL, maxiter=300)
    if kind == "dense":
        a = csr.to_dense()
    elif kind == "tensor":
        a = torch.tensor(csr.to_dense())
    elif kind == "scipy":
        a = pytest.importorskip("scipy.sparse").csr_matrix(csr.to_dense())
    else:
        a = T.CsrOperator.from_csr(tcsr, dtype=torch.float64, device="cpu")
    jplan = J.plan(csr, J.SaPOptions(p=4, variant="C", tol=TOL, maxiter=300))
    tplan = RT.plan(a, opts, device="cpu")
    np.testing.assert_array_equal(tplan.b_perm, jplan.b_perm)
    _compare(RT.factor(tplan).solve(b), J.factor(jplan).solve(jnp.asarray(b)))


def test_plan_of_a_banded_operator_skips_the_front_end():
    band = T.random_banded(64, 3, 1.0, seed=0).astype(np.float32)
    op = T.BandedOperator.from_band(torch.tensor(band))
    pl = RT.plan(op, T.SaPOptions(p=2), device="cpu")
    assert pl.b_perm is None and pl.x_perm is None and pl.k == 3


def test_plan_rejects_band_storage_arrays():
    with pytest.raises(TypeError, match="square"):
        RT.plan(np.zeros((50, 7)), T.SaPOptions(p=2), device="cpu")


def test_plan_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, csr, _ = _system("d1")
    with pytest.raises(RuntimeError, match="CUDA"):
        RT.plan(csr, T.SaPOptions(p=4))
    with pytest.warns(DeprecationWarning), pytest.raises(RuntimeError, match="CUDA"):
        T.solve_sparse(csr, np.ones(csr.n), T.SaPOptions(p=4))
    assert RT.plan(csr, T.SaPOptions(p=4), device="cpu").band_pc.device.type == "cpu"


@pytest.mark.parametrize("dense", [False, True])
def test_legacy_solve_sparse_matches_jax(dense):
    csr, tcsr, b = _system("d07")
    opts = dict(p=4, variant="auto", tol=TOL, maxiter=300)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tsol = T.solve_sparse(csr.to_dense() if dense else tcsr, b, T.SaPOptions(**opts),
                              device="cpu")
        jsol = J.solve_sparse(csr.to_dense() if dense else csr, b, J.SaPOptions(**opts))
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert tsol.info.keys() == jsol.info.keys()
    assert tsol.info.pop("d_factor") == pytest.approx(jsol.info.pop("d_factor"), rel=1e-6)
    assert tsol.info == jsol.info
    assert tsol.k == jsol.k
    assert np.linalg.norm(tsol.x.numpy() - jsol.x) <= 1e-4 * np.linalg.norm(jsol.x)
    assert tsol.true_resnorm <= 10 * TOL


def test_carry_across_a_jax_sparse_factorization():
    """A JAX factorization of a sparse plan (COO operator, permutations, BCR
    reduced chain) carried across as numpy leaves solves as the JAX one."""
    jplan, _, jfac, _ = _pair("d07", (("p", 10), ("variant", "E")))
    pc = jfac.pc
    arrays = {
        "op.data": jfac.op.data, "op.rows": jfac.op.rows, "op.cols": jfac.op.cols,
        "b_perm": jfac.b_perm, "x_perm": jfac.x_perm,
        "lu.sinv": pc.lu.sinv, "lu.l": pc.lu.l, "lu.f": pc.lu.f,
        "b_cpl": pc.b_cpl, "c_cpl": pc.c_cpl,
        "red_bcr.root_inv": pc.red_bcr.root_inv, "d_factor": jfac.d_factor,
    }
    for lvl, level in enumerate(pc.red_bcr.levels):
        for name, leaf in zip(level._fields, level):
            arrays[f"red_bcr.{lvl}.{name}"] = leaf
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    meta = dict(variant=pc.variant, p=pc.p, m=pc.m, k=pc.k, n=jfac.n, tol=jfac.tol,
                maxiter=jfac.maxiter, solver=jfac.solver, red_bcr_m=pc.red_bcr.m)
    tfac = T.factorization_from_numpy(arrays, meta, device="cpu")
    assert isinstance(tfac.op, T.CsrOperator) and tfac.pc.reduced_solver == "bcr"
    assert tfac.op.rows.dtype == torch.int64
    _, _, b = _system("d07")
    _compare(tfac.solve(b), jfac.solve(jnp.asarray(b)))
