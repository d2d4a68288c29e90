"""All-active parallel cyclic reduction (``pcr_factor`` / ``pcr_solve`` of
``repro_torch.core.cyclic_reduction``) against the JAX package's, in this
process, and against a dense solve of the chain.

Chains of m blocks of 2K = 12 with every block scaled by 1/sqrt(2K) and
the diagonal shifted by 3 I, so the chain stays well conditioned at every
length; m = 1, 2, 3, 5, 9 and 16 give 0 to 4 levels.  Tolerance: 1e-5 of
the largest value, float32 both sides (the same eliminations; the block
inverses by the same boosted Gauss-Jordan, the products' sums in another
order); against the float64 dense solve, 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cyclic_reduction as jcr
from repro_torch.core import cyclic_reduction as cr
from repro_torch.core.block_lu import gj_inverse

K2 = 12
LENGTHS = (1, 2, 3, 5, 9, 16)


def _chain(m, seed=0, shift=3.0):
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(K2)
    d = rng.normal(size=(m, K2, K2)) * scale + shift * np.eye(K2)
    e = rng.normal(size=(m, K2, K2)) * scale
    f = rng.normal(size=(m, K2, K2)) * scale
    e[0] = 0.0
    f[-1] = 0.0
    return d, e, f


def _dense(d, e, f):
    m = d.shape[0]
    a = np.zeros((m * K2, m * K2))
    for i in range(m):
        a[i * K2:(i + 1) * K2, i * K2:(i + 1) * K2] = d[i]
        if i:
            a[i * K2:(i + 1) * K2, (i - 1) * K2:i * K2] = e[i]
        if i < m - 1:
            a[i * K2:(i + 1) * K2, (i + 1) * K2:(i + 2) * K2] = f[i]
    return a


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    if want.size == 0:
        assert np.asarray(got).size == 0
        return
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("m", LENGTHS)
def test_levels_match_jax(m):
    assert cr.pcr_n_levels(m) == jcr.pcr_n_levels(m)
    assert cr.pcr_n_levels(m) == {1: 0, 2: 1, 3: 2, 5: 3, 9: 4, 16: 4}[m]


@pytest.mark.parametrize("m", LENGTHS)
def test_factor_matches_jax(m):
    d, e, f = _chain(m)
    lv = cr.pcr_n_levels(m)
    got = cr.pcr_factor(*(torch.tensor(x, dtype=torch.float32) for x in (d, e, f)), lv)
    want = jcr.pcr_factor(*(jnp.asarray(x, jnp.float32) for x in (d, e, f)), lv)
    assert got.n_levels == want.n_levels == lv
    assert tuple(got.alphas.shape) == tuple(want.alphas.shape) == (m, lv, K2, K2)
    for g, w in ((got.alphas, want.alphas), (got.betas, want.betas), (got.dinv, want.dinv)):
        _close(g.numpy(), w, 1e-5)


@pytest.mark.parametrize("r", (1, 3))
@pytest.mark.parametrize("m", LENGTHS)
def test_solve_matches_jax_and_a_dense_solve(m, r):
    d, e, f = _chain(m, seed=m)
    lv = cr.pcr_n_levels(m)
    b = np.random.default_rng(100 + m).normal(size=(m, K2, r))
    fac = cr.pcr_factor(*(torch.tensor(x, dtype=torch.float32) for x in (d, e, f)), lv)
    got = cr.pcr_solve(fac, torch.tensor(b, dtype=torch.float32)).numpy()
    jfac = jcr.pcr_factor(*(jnp.asarray(x, jnp.float32) for x in (d, e, f)), lv)
    _close(got, jcr.pcr_solve(jfac, jnp.asarray(b, jnp.float32)), 1e-5)
    dense = np.linalg.solve(_dense(d, e, f), b.reshape(m * K2, r)).reshape(m, K2, r)
    _close(got, dense, 1e-4)


def test_too_few_levels_leave_the_chain_coupled():
    """One level short of pcr_n_levels, the solve is not the chain's (a
    weakly dominant chain, whose couplings reach across the missing stride)."""
    m = 9
    d, e, f = _chain(m, seed=3, shift=1.0)
    b = np.random.default_rng(4).normal(size=(m, K2, 1))
    fac = cr.pcr_factor(*(torch.tensor(x) for x in (d, e, f)), cr.pcr_n_levels(m) - 1)
    dense = np.linalg.solve(_dense(d, e, f), b.reshape(-1, 1)).reshape(m, K2, 1)
    assert float(np.abs(cr.pcr_solve(fac, torch.tensor(b)).numpy() - dense).max()) > 1e-3


def test_block_inverses_go_through_inv_odd_as_gj_inverse():
    """The level inverses (one inv_odd call on the blocks interleaved with
    identity blocks) equal gj_inverse of the blocks, bit for bit, on the
    CPU, where the wrapper runs its plain version and launches nothing."""
    from repro_torch.kernels import bcr

    d, _, _ = _chain(5, seed=7)
    a = torch.tensor(d, dtype=torch.float32)
    before = bcr.inv_odd.launches
    torch.testing.assert_close(cr._vinv(a, 1e-10), gj_inverse(a, 1e-10), rtol=0, atol=0)
    assert bcr.inv_odd.launches == before  # the CPU runs the plain version: no launch


def test_injected_shifts_are_used():
    """pcr_factor / pcr_solve call the injected shifts (the distributed
    path's hook): counting wrappers around the local ones see two shifts a
    level in the factor (the stacked blocks down and up) and two a level in
    the solve."""
    m = 5
    d, e, f = _chain(m, seed=5)
    calls = []

    def dn(x, s):
        calls.append(("dn", s))
        return cr._shift_dn(x, s)

    def up(x, s):
        calls.append(("up", s))
        return cr._shift_up(x, s)

    lv = cr.pcr_n_levels(m)
    fac = cr.pcr_factor(*(torch.tensor(x) for x in (d, e, f)), lv, shift_dn=dn, shift_up=up)
    assert calls == [(w, 1 << lv_) for lv_ in range(lv) for w in ("dn", "up")]
    calls.clear()
    cr.pcr_solve(fac, torch.ones(m, K2, 2, dtype=torch.float64), shift_dn=dn, shift_up=up)
    assert calls == [(w, 1 << lv_) for lv_ in range(lv) for w in ("dn", "up")]
