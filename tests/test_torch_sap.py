"""The port's dense-banded SaP slice as a whole against the JAX lifecycle.

``factor(plan_banded(band, opts)).solve(b)`` and ``.solve_many(B)`` on both
packages, same numpy band and RHS, float32 throughout (JAX x64 off).  The
JAX ``converged`` flag can be true on a wrong answer, so the comparison is
on what the answer is:

* x: normwise relative difference to the JAX x at most 1e-4 -- float32
  Krylov iterations whose sums run in another order;
* true_resnorm: both at most 10 * tol;
* iterations: equal or within one sweep (a quarter-exit can flip on
  float32 rounding).

A carry-across test rebuilds the port's handle from the leaves of a JAX
``SaPFactorization`` flattened to numpy and checks its preconditioner apply
and its solve against the JAX handle's.
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

TOL = 1e-6

SYSTEMS = {
    # name: (generator, n, k, d)
    "rand_d1": ("random_banded", 256, 4, 1.0),
    "rand_d2": ("random_banded", 256, 4, 2.0),
    "osc_d05": ("oscillatory_banded", 200, 5, 0.5),
}


def _system(name, nrhs=None, seed=0):
    gen, n, k, d = SYSTEMS[name]
    band = getattr(J, gen)(n, k, d, seed=seed).astype(np.float32)
    dense = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    rng = np.random.default_rng(seed + 1)
    xstar = rng.normal(size=(n,) if nrhs is None else (n, nrhs))
    return band, (dense @ xstar).astype(np.float32)


def _compare(tres, jres):
    tx, jx = tres.x.numpy(), np.asarray(jres.x)
    assert tx.shape == jx.shape
    assert np.linalg.norm(tx - jx, axis=0).max() <= 1e-4 * np.linalg.norm(jx, axis=0).min()
    assert np.max(tres.true_resnorm.numpy()) <= 10 * TOL
    assert np.max(np.asarray(jres.true_resnorm)) <= 10 * TOL
    assert np.abs(tres.iterations.numpy() - np.asarray(jres.iterations)).max() <= 1.0


CASES = [
    # variant, system, p, resolved variant
    ("C", "rand_d1", 4, "C"),
    ("D", "rand_d2", 4, "D"),
    ("E", "osc_d05", 4, "E"),
    ("auto", "rand_d2", 4, "C"),
    ("auto", "osc_d05", 4, "E"),
]


@functools.lru_cache(maxsize=None)  # one factorization per case for all tests
def _pair(variant, system, p):
    band, _ = _system(system)
    jopts = J.SaPOptions(p=p, variant=variant, tol=TOL, maxiter=300)
    topts = T.SaPOptions(p=p, variant=variant, tol=TOL, maxiter=300)
    jfac = J.factor(J.plan_banded(jnp.asarray(band), jopts))
    tfac = RT.factor(RT.plan_banded(band, topts, device="cpu"))
    return jfac, tfac


@pytest.mark.parametrize("variant,system,p,resolved", CASES)
def test_solve_matches_jax_lifecycle(variant, system, p, resolved):
    jfac, tfac = _pair(variant, system, p)
    assert tfac.variant == jfac.variant == resolved
    assert (tfac.p, tfac.n_pad, tfac.pc.reduced_solver) == (jfac.p, jfac.n_pad, jfac.pc.reduced_solver)
    assert float(tfac.d_factor) == pytest.approx(float(jfac.d_factor), rel=1e-6)
    _, b = _system(system)
    tres = tfac.solve(b)
    _compare(tres, jfac.solve(jnp.asarray(b)))
    assert tres.x.shape == (b.shape[0],) and tres.iterations.ndim == 0


@pytest.mark.parametrize("variant,system,p,resolved", CASES[:3])
def test_solve_many_matches_jax_lifecycle(variant, system, p, resolved):
    jfac, tfac = _pair(variant, system, p)
    _, bmat = _system(system, nrhs=3)
    tres = tfac.solve_many(bmat)
    _compare(tres, jfac.solve_many(jnp.asarray(bmat)))
    assert tres.iterations.shape == (3,) and tres.true_resnorm.shape == (3,)
    # one column solved alone gives that column's solve_many answer
    one = tfac.solve(bmat[:, 1])
    assert torch.allclose(one.x, tres.x[:, 1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("solver", ["refine", "cg", "use_cg"])
def test_outer_solvers_match_jax(solver):
    # "use_cg" is the legacy spelling of solver="cg", resolved at factor()
    kw = dict(use_cg=True) if solver == "use_cg" else dict(solver=solver)
    want = "cg" if solver == "use_cg" else solver
    system = "rand_d2"
    if want == "cg":  # CG needs an SPD operator: symmetrize the band
        band, _ = _system(system)
        dense = np.asarray(J.band_to_dense(jnp.asarray(band)))
        dense = (dense + dense.T) / 2
        band = np.array(J.dense_to_band(jnp.asarray(dense), 4))
        band[:, 4] = np.abs(band).sum(1) + 1.0
    else:
        band, _ = _system(system)
    b = (np.asarray(J.band_to_dense(jnp.asarray(band))) @ np.ones(band.shape[0])).astype(np.float32)
    jfac = J.factor(J.plan_banded(jnp.asarray(band), J.SaPOptions(p=4, tol=TOL, **kw)))
    tfac = RT.factor(RT.plan_banded(band, T.SaPOptions(p=4, tol=TOL, **kw), device="cpu"))
    assert tfac.solver == jfac.solver == want
    _compare(tfac.solve(b), jfac.solve(jnp.asarray(b)))


def test_mixed_precision_iterates_in_the_rhs_dtype():
    """float32 preconditioner, float64 iteration (paper Sec. 3.1): iterative
    refinement recomputes the true residual every sweep and reaches a
    float64-level answer the float32 factors alone cannot give."""
    band, b = _system("rand_d1")
    opts = T.SaPOptions(p=4, tol=1e-12, solver="refine")
    fac = RT.factor(RT.plan_banded(band, opts, device="cpu"))
    res = fac.solve(b.astype(np.float64))
    assert res.x.dtype == torch.float64 and fac.pc.lu.sinv.dtype == torch.float32
    assert bool(res.converged) and float(res.true_resnorm) <= 1e-11
    assert fac.solve(b).x.dtype == torch.float32


def test_history_matches_jax_shape():
    jfac, tfac = _pair("D", "rand_d2", 4)
    _, b = _system("rand_d2")
    tres = tfac.solve(b, record_history=True)
    jres = jfac.solve(jnp.asarray(b), record_history=True)
    assert tres.history.shape == jres.history.shape == (300,)
    assert np.count_nonzero(~np.isnan(tres.history.numpy())) == int(np.ceil(float(tres.iterations)))


def test_legacy_solve_banded():
    band, b = _system("rand_d1")
    opts = T.SaPOptions(p=4, variant="C", tol=TOL)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sol = T.solve_banded(band, b, opts, device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    res = RT.factor(RT.plan_banded(band, opts, device="cpu")).solve(b)
    torch.testing.assert_close(sol.x, res.x)
    assert sol.info["variant"] == "C" and sol.true_resnorm <= 10 * TOL


def test_rhs_shape_is_checked():
    band, b = _system("rand_d1")
    fac = RT.factor(RT.plan_banded(band, T.SaPOptions(p=4), device="cpu"))
    with pytest.raises(ValueError):
        fac.solve(b[:, None])
    with pytest.raises(ValueError):
        fac.solve_many(b)
    with pytest.raises(ValueError):
        fac.solve(b[:-1])


# ---------------------------------------------------------------------------
# carry-across: a JAX factorization's leaves rebuild the port's handle
# ---------------------------------------------------------------------------


def _flatten(jfac):
    pc = jfac.pc
    arrays = {
        "op.band": jfac.op.band,
        "lu.sinv": pc.lu.sinv, "lu.l": pc.lu.l, "lu.f": pc.lu.f,
        "b_cpl": pc.b_cpl, "c_cpl": pc.c_cpl,
        "v_bot": pc.v_bot, "w_top": pc.w_top, "rbar_inv": pc.rbar_inv,
        "d_factor": jfac.d_factor,
    }
    if pc.red_lu is not None:
        arrays.update({"red_lu.sinv": pc.red_lu.sinv, "red_lu.l": pc.red_lu.l, "red_lu.f": pc.red_lu.f})
    arrays = {name: np.asarray(a) for name, a in arrays.items() if a is not None}
    meta = dict(variant=pc.variant, p=pc.p, m=pc.m, k=pc.k, tol=jfac.tol, maxiter=jfac.maxiter,
                solver=jfac.solver)
    return arrays, meta


@pytest.mark.parametrize("variant,system,p", [("C", "rand_d1", 4), ("E", "osc_d05", 4), ("D", "rand_d2", 4)])
def test_carry_across_from_jax_factorization(variant, system, p):
    _, b = _system(system)
    jfac, _ = _pair(variant, system, p)
    arrays, meta = _flatten(jfac)
    tfac = T.factorization_from_numpy(arrays, meta, device="cpu")
    assert (tfac.variant, tfac.p, tfac.n_pad, tfac.n, tfac.k) == (
        jfac.variant, jfac.p, jfac.n_pad, jfac.n, jfac.k)
    r = np.random.default_rng(9).normal(size=jfac.n_pad).astype(np.float32)
    tz, jz = tfac.pc.apply(torch.tensor(r)).numpy(), np.asarray(jfac.pc.apply(jnp.asarray(r)))
    # the same stored factors applied: only the solve's sums differ in order
    assert np.abs(tz - jz).max() <= 1e-5 * np.abs(jz).max()
    _compare(tfac.solve(b), jfac.solve(jnp.asarray(b)))


def test_carry_across_rejects_unknown_leaves():
    with pytest.raises(ValueError, match="unknown"):
        T.factorization_from_numpy({"lu.sinvv": np.zeros(1)}, {}, device="cpu")
