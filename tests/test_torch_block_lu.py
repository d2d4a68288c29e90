"""The port's plain block-tridiagonal versions against the JAX package.

Each plain version in ``repro_torch.core.block_lu`` (the CPU path of every
CUDA kernel wrapper) is held against both the JAX jnp reference and the
JAX Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerance: rtol=1e-5, atol=1e-6 on float32 -- the same algorithm in float32
on both sides, with the matrix-product sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_lu as jbl
from repro.kernels import ops as jops
from repro_torch.core import block_lu as tbl
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-5, atol=1e-6)


def _chain(rng, p, m, k, pad_partitions=0):
    """Diagonally dominant (P, M, K, K) chain plus (P-1, K, K) couplings;
    the last ``pad_partitions`` partitions are identity padding (zero
    off-diagonal blocks and couplings, as band_to_block_tridiag makes)."""
    d = rng.normal(size=(p, m, k, k)) + 4 * np.eye(k)
    e = rng.normal(size=(p, m, k, k)) * 0.3
    f = rng.normal(size=(p, m, k, k)) * 0.3
    e[:, 0] = 0.0
    f[:, m - 1] = 0.0
    b_cpl = rng.normal(size=(max(p - 1, 0), k, k)) * 0.3
    c_cpl = rng.normal(size=(max(p - 1, 0), k, k)) * 0.3
    if pad_partitions:
        d[p - pad_partitions :] = np.eye(k)
        e[p - pad_partitions :] = 0.0
        f[p - pad_partitions :] = 0.0
        b_cpl[p - pad_partitions - 1 :] = 0.0
        c_cpl[p - pad_partitions - 1 :] = 0.0
    return tuple(x.astype(np.float32) for x in (d, e, f, b_cpl, c_cpl))


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


# ---------------------------------------------------------------------------
# Gauss-Jordan inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_gj_inverse_matches_jax(k):
    rng = np.random.default_rng(k)
    a = (rng.normal(size=(k, k)) + 3 * np.eye(k)).astype(np.float32)
    _close(tbl.gj_inverse(_t(a)), jbl.gj_inverse(jnp.asarray(a)))


def test_gj_inverse_structural_zero_row_takes_pivot_one():
    """A structurally zero row keeps the identity on its slot (no 1/thr)."""
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(5, 5)) + 3 * np.eye(5)).astype(np.float32)
    a[2, :] = 0.0
    a[:, 2] = 0.0
    port = tbl.gj_inverse(_t(a))
    _close(port, jbl.gj_inverse(jnp.asarray(a)))
    assert float(port[2, 2]) == 1.0
    assert float(port.abs().max()) < 10.0


def test_gj_inverse_boosts_tiny_pivot():
    """A numerically tiny (not structurally zero) pivot is boosted to
    boost_eps * max|A| with its sign, as in the JAX package."""
    a = np.array([[1e-12, 0.5, 0.0], [0.0, 2.0, 0.5], [0.0, 0.5, 3.0]], np.float32)
    for piv in (1e-12, -1e-12, 0.0):
        a[0, 0] = piv
        port = tbl.gj_inverse(_t(a), 1e-6)
        _close(port, jbl.gj_inverse(jnp.asarray(a), 1e-6))
        thr = np.float32(1e-6) * np.float32(3.0)
        assert float(port[0, 0]) == pytest.approx((-1.0 if piv < 0 else 1.0) / thr, rel=1e-6)


def test_gj_inverse_batched_over_leading_axes():
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(3, 2, 4, 4)) + 3 * np.eye(4)).astype(np.float32)
    port = tbl.gj_inverse(_t(a))
    for i in range(3):
        for j in range(2):
            _close(port[i, j], jbl.gj_inverse(jnp.asarray(a[i, j])))


# ---------------------------------------------------------------------------
# factor / solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,m,k", [(1, 1, 3), (2, 4, 5), (4, 2, 8), (2, 1, 2)])
def test_btf_matches_jnp_and_interpret_kernel(p, m, k):
    rng = np.random.default_rng(10 + p * m * k)
    d, e, f, _, _ = _chain(rng, p, m, k)
    port = tops.block_tridiag_factor(_t(d), _t(e), _t(f))
    jd, je, jf = (jnp.asarray(x) for x in (d, e, f))
    for impl in ("jnp", "interpret"):
        ref = jops.block_tridiag_factor(jd, je, jf, impl=impl)
        _close(port.sinv, ref.sinv)
        # at M = 1 the jnp reference's l comes out with shape (P, 0, K, K)
        # (an empty scan); the interpret kernel gives the zero block
        if m > 1 or impl == "interpret":
            _close(port.l, ref.l)


@pytest.mark.parametrize("p,m,k,r", [(2, 3, 4, 1), (1, 1, 5, 3), (4, 2, 3, 8), (2, 4, 8, 2)])
def test_bts_matches_jnp_and_interpret_kernel(p, m, k, r):
    rng = np.random.default_rng(20 + p * m * k * r)
    d, e, f, _, _ = _chain(rng, p, m, k)
    b = rng.normal(size=(p, m, k, r)).astype(np.float32)
    jfac = jops.block_tridiag_factor(*(jnp.asarray(x) for x in (d, e, f)), impl="interpret")
    tfac = tbl.BTFactors(*(_t(x) for x in jfac))
    port = tops.block_tridiag_solve(tfac, _t(b))
    for impl in ("jnp", "interpret"):
        _close(port, jops.block_tridiag_solve(jfac, jnp.asarray(b), impl=impl))


def test_btf_bts_solve_the_block_system():
    """factor + solve reproduce x for the assembled dense partitions."""
    rng = np.random.default_rng(3)
    p, m, k = 2, 3, 4
    d, e, f, _, _ = _chain(rng, p, m, k)
    fac = tops.block_tridiag_factor(_t(d), _t(e), _t(f))
    x = rng.normal(size=(p, m, k, 2)).astype(np.float32)
    b = np.zeros_like(x)
    for j in range(m):
        b[:, j] = d[:, j] @ x[:, j]
        if j > 0:
            b[:, j] += e[:, j] @ x[:, j - 1]
        if j < m - 1:
            b[:, j] += f[:, j] @ x[:, j + 1]
    np.testing.assert_allclose(tops.block_tridiag_solve(fac, _t(b)).numpy(), x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m,k", [(3, 4), (1, 6)])
def test_chain_forms_match_jax(m, k):
    rng = np.random.default_rng(30 + m)
    d, e, f, _, _ = _chain(rng, 1, m, k)
    d, e, f = d[0], e[0], f[0]
    jfac = jops.block_tridiag_factor_chain(*(jnp.asarray(x) for x in (d, e, f)), impl="interpret")
    port = tops.block_tridiag_factor_chain(_t(d), _t(e), _t(f))
    _close(port.sinv, jfac.sinv)
    _close(tbl.btf_chain(_t(d), _t(e), _t(f)).sinv, jbl.btf_chain(*(jnp.asarray(x) for x in (d, e, f))).sinv)
    b = rng.normal(size=(m, k, 3)).astype(np.float32)
    ref = jops.block_tridiag_solve_chain(jfac, jnp.asarray(b), impl="interpret")
    _close(tops.block_tridiag_solve_chain(port, _t(b)), ref)
    _close(tbl.bts_chain(port, _t(b)), ref)


def test_flip_and_ul_factor_match_jax():
    rng = np.random.default_rng(4)
    d, e, f, _, _ = _chain(rng, 3, 4, 5)
    jd, je, jf = (jnp.asarray(x) for x in (d, e, f))
    for port, ref in zip(tbl.flip_block_tridiag(_t(d), _t(e), _t(f)), jbl.flip_block_tridiag(jd, je, jf)):
        _close(port, ref, rtol=0, atol=0)
    port = tbl.btf_ul_ref(_t(d), _t(e), _t(f))
    ref = jbl.btf_ul_ref(jd, je, jf)
    _close(port.sinv, ref.sinv)
    _close(port.l, ref.l)


# ---------------------------------------------------------------------------
# fused factor + spike
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "p,m,k,pad", [(2, 3, 4, 0), (3, 5, 3, 0), (4, 1, 4, 0), (4, 2, 5, 1), (3, 4, 2, 2)]
)
def test_fused_factor_spike_matches_jnp_and_interpret_kernel(p, m, k, pad):
    """Including identity-padded partitions (zero couplings): their corner
    blocks come out exactly zero on both sides."""
    rng = np.random.default_rng(40 + p * m * k + pad)
    d, e, f, b_cpl, c_cpl = _chain(rng, p, m, k, pad_partitions=pad)
    port = tops.fused_factor_spike(*(_t(x) for x in (d, e, f, b_cpl, c_cpl)))
    for impl in ("jnp", "interpret"):
        ref = jops.fused_factor_spike(*(jnp.asarray(x) for x in (d, e, f, b_cpl, c_cpl)), impl=impl)
        for name in ("v_bot", "v_top", "w_top", "w_bot"):
            _close(getattr(port, name), getattr(ref, name))
        _close(port.lu.sinv, ref.lu.sinv)
        _close(port.lu.l, ref.lu.l)
    if pad:
        assert float(port.v_bot[-1].abs().max()) == 0.0
        assert float(port.w_top[-1].abs().max()) == 0.0


def test_fused_matches_btf_ul_sequence():
    """v_bot / w_top of the fused pass equal the btf -> UL-btf formulation."""
    rng = np.random.default_rng(5)
    d, e, f, b_cpl, c_cpl = (_t(x) for x in _chain(rng, 3, 4, 4))
    fs = tbl.fused_factor_spike_ref(d, e, f, b_cpl, c_cpl)
    lu = tbl.btf_ref(d, e, f)
    ul = tbl.btf_ul_ref(d, e, f)
    torch.testing.assert_close(fs.lu.sinv, lu.sinv, **TOL)
    torch.testing.assert_close(fs.v_bot, lu.sinv[:-1, -1] @ b_cpl, **TOL)
    torch.testing.assert_close(fs.w_top, (ul.sinv[1:, -1] @ c_cpl.flip(-2)).flip(-2), **TOL)


def test_pad_couplings_layout():
    rng = np.random.default_rng(6)
    _, _, _, b_cpl, c_cpl = _chain(rng, 3, 1, 2)
    bq, cq = tbl.pad_couplings(_t(b_cpl), _t(c_cpl), 3)
    jbq, jcq = jbl.pad_couplings(jnp.asarray(b_cpl), jnp.asarray(c_cpl), 3)
    _close(bq, jbq, rtol=0, atol=0)
    _close(cq, jcq, rtol=0, atol=0)


def test_plain_versions_compute_in_float32_and_store_the_input_dtype():
    rng = np.random.default_rng(7)
    d, e, f, _, _ = _chain(rng, 2, 3, 4)
    fac64 = tbl.btf_ref(*(torch.tensor(x, dtype=torch.float64) for x in (d, e, f)))
    fac32 = tbl.btf_ref(_t(d), _t(e), _t(f))
    assert fac64.sinv.dtype == torch.float64
    torch.testing.assert_close(fac64.sinv.float(), fac32.sinv, rtol=0, atol=0)
