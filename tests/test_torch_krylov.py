"""The port's Krylov solvers against the JAX package.

Same operator, same preconditioner (the JAX jnp SaP-C factors, carried
across as numpy), same right-hand sides.  Iterations must agree exactly
or within one sweep (a quarter-exit can flip on float32 rounding); x is
compared normwise at 1e-4 -- float32 iterations whose inner products sum
in another order -- and true_resnorm against 10 * tol on both sides.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jb
from repro.core import krylov as jk
from repro.core import spike as js
from repro_torch.core import banded as tb
from repro_torch.core import krylov as tk
from repro_torch.core import spike as ts

TOL = 1e-6


@functools.lru_cache(maxsize=None)  # JAX compiles once per preconditioner closure
def _setup(n=96, k=3, p=4, d=1.0, seed=0, spd=False):
    band = jb.random_banded(n, k, d, seed=seed).astype(np.float32)
    if spd:  # symmetric, diagonally dominant: SPD
        dense = np.asarray(jb.band_to_dense(jnp.asarray(band)))
        dense = (dense + dense.T) / 2
        band = np.array(jb.dense_to_band(jnp.asarray(dense), k))
        band[:, k] = np.abs(band).sum(1) + 1.0
    n_pad = p * jb.padded_partition_size(n, p, k)
    tbt = tb.band_to_block_tridiag(torch.tensor(band), k, p)
    jbt = jb.band_to_block_tridiag(jnp.asarray(band), k, p)
    tpc = ts.build_preconditioner(tbt, variant="C")
    jpc = js.build_preconditioner(jbt, variant="C", impl="jnp")

    def tpre(r):
        pad = torch.zeros((n_pad - n,) + tuple(r.shape[1:]), dtype=r.dtype)
        return tpc.apply(torch.cat([r, pad]))[:n]

    def jpre(r):
        return jpc.apply(jnp.concatenate([r, jnp.zeros((n_pad - n,), r.dtype)]))[:n]

    tband, jband = torch.tensor(band), jnp.asarray(band)
    return (
        lambda x: tb.band_matvec(tband, x),
        tpre,
        lambda x: jb.band_matvec(jband, x),
        jpre,
        band,
    )


def _check(tres, jres, tol=TOL):
    assert abs(float(tres.iterations) - float(jres.iterations)) <= 1.0
    tx, jx = tres.x.numpy(), np.asarray(jres.x)
    assert np.abs(tx - jx).max() <= 1e-4 * np.abs(jx).max()
    assert float(tres.true_resnorm) <= 10 * tol
    assert float(jres.true_resnorm) <= 10 * tol


@pytest.mark.parametrize("solver", ["bicgstab2", "refine", "cg"])
def test_single_rhs_matches_jax(solver):
    tmv, tpre, jmv, jpre, band = _setup(spd=solver == "cg", d=2.0 if solver == "refine" else 1.0)
    n = band.shape[0]
    b = np.random.default_rng(1).normal(size=n).astype(np.float32)
    tres = getattr(tk, solver)(tmv, torch.tensor(b), tpre, tol=TOL, maxiter=100)
    jres = getattr(jk, solver)(jmv, jnp.asarray(b), jpre, tol=TOL, maxiter=100)
    _check(tres, jres)
    assert bool(tres.converged) == bool(jres.converged)


def _column(res, c):
    """Column c of a multi-RHS result: x[:, c] and the (R,) diagnostics' [c]."""
    return type(res)(
        x=res.x[:, c], iterations=res.iterations[c], resnorm=res.resnorm[c],
        converged=res.converged[c], true_resnorm=res.true_resnorm[c],
    )


@pytest.mark.parametrize("solver", ["bicgstab2_many", "refine_many", "cg_many"])
def test_many_rhs_matches_jax_per_column(solver):
    """Columns converge independently: per-column (R,) diagnostics, and a
    column that converges early (the zero RHS) freezes while others run."""
    spd, d = solver == "cg_many", 2.0 if "refine" in solver else 1.0
    tmv, tpre, jmv, jpre, band = _setup(spd=spd, d=d)
    n = band.shape[0]
    rng = np.random.default_rng(2)
    b = np.stack([rng.normal(size=n), np.zeros(n), 3 * rng.normal(size=n)], 1).astype(np.float32)
    tres = getattr(tk, solver)(tmv, torch.tensor(b), tpre, tol=TOL, maxiter=100)
    jres = getattr(jk, solver)(jmv, jnp.asarray(b), jpre, tol=TOL, maxiter=100)
    assert tres.x.shape == (n, 3) and tres.iterations.shape == (3,)
    assert float(tres.iterations[1]) == 0.0
    for c in range(3):
        _check(_column(tres, c), _column(jres, c))


def test_unpreconditioned_bicgstab2_matches_jax():
    tmv, _, jmv, _, band = _setup(d=2.0)
    b = np.random.default_rng(3).normal(size=band.shape[0]).astype(np.float32)
    tres = tk.bicgstab2(tmv, torch.tensor(b), tol=TOL, maxiter=200)
    jres = jk.bicgstab2(jmv, jnp.asarray(b), tol=TOL, maxiter=200)
    _check(tres, jres)


@pytest.mark.parametrize("many", [False, True])
def test_history_length_and_nan_padding(many):
    """Unpreconditioned, so the run takes several sweeps."""
    tmv, _, jmv, _, band = _setup(d=2.0)
    n = band.shape[0]
    b = np.random.default_rng(4).normal(size=(n, 2) if many else n).astype(np.float32)
    fn = "bicgstab2_many" if many else "bicgstab2"
    tres = getattr(tk, fn)(tmv, torch.tensor(b), tol=1e-5, maxiter=30, record_history=True)
    jres = getattr(jk, fn)(jmv, jnp.asarray(b), tol=1e-5, maxiter=30, record_history=True)
    th, jh = np.atleast_2d(tres.history.numpy()), np.atleast_2d(np.asarray(jres.history))
    assert th.shape == jh.shape == ((2, 30) if many else (1, 30))
    for row, it in zip(th, np.atleast_1d(tres.iterations.numpy())):
        recorded = np.count_nonzero(~np.isnan(row))
        assert recorded == int(np.ceil(it)) > 1
        assert np.isnan(row[recorded:]).all()
    # float32 rounding differences grow along a BiCGStab trajectory, so the
    # exits may lie a few sweeps apart; the first sweeps agree closely
    np.testing.assert_allclose(th[:, :2], jh[:, :2], rtol=1e-3)


def test_maxiter_caps_the_sweeps():
    tmv, _, _, _, band = _setup(d=0.3)
    b = torch.tensor(np.random.default_rng(5).normal(size=band.shape[0]).astype(np.float32))
    res = tk.bicgstab2(tmv, b, tol=1e-30, maxiter=3, record_history=True)
    assert float(res.iterations) <= 3.0
    assert not bool(res.converged)
    assert res.history.shape == (3,)
