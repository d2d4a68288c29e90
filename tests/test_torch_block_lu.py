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


# the shapes the cluster route must handle besides: P = 1 with a long chain,
# M = 1 and M = 2, K not a multiple of 4, and R in {1, 4, 9} (9: the
# one-block kernel's R > 8)
@pytest.mark.parametrize("p,m,k,r", [(2, 3, 4, 1), (1, 1, 5, 3), (4, 2, 3, 8), (2, 4, 8, 2),
                                     (1, 24, 6, 1), (1, 24, 6, 9), (3, 1, 7, 4), (2, 2, 5, 9),
                                     (2, 2, 12, 4), (1, 9, 10, 4)])
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
    """The plain versions compute in the wider of float32 and the storage:
    float32 storage in float32, as before (the float64 factors differ from
    it); float64 storage in float64, equal to the JAX package's float64
    btf_ref, bts_ref and fused pass within 1e-12."""
    import jax

    rng = np.random.default_rng(7)
    d, e, f, b_cpl, c_cpl = _chain(rng, 2, 3, 4)
    b = rng.normal(size=(2, 3, 4, 2))
    t64 = [torch.tensor(x, dtype=torch.float64) for x in (d, e, f, b_cpl, c_cpl, b)]
    fac64 = tbl.btf_ref(*t64[:3])
    fac32 = tbl.btf_ref(_t(d), _t(e), _t(f))
    assert fac64.sinv.dtype == torch.float64 and fac32.sinv.dtype == torch.float32
    want32 = np.linalg.inv(d[:, 0].astype(np.float32))
    np.testing.assert_allclose(fac32.sinv[:, 0].numpy(), want32, rtol=1e-5, atol=1e-6)
    assert float((fac64.sinv.float() - fac32.sinv).abs().max()) > 0.0
    x64 = tbl.bts_ref(fac64, t64[5])
    fs64 = tbl.fused_factor_spike_ref(*t64[:5])
    assert x64.dtype == torch.float64 and fs64.v_bot.dtype == torch.float64
    with jax.enable_x64(True):
        j64 = [jnp.asarray(x.numpy()) for x in t64]
        jfac = jbl.btf_ref(*j64[:3])
        jx = jbl.bts_ref(jfac, j64[5])
        jfs = jbl.fused_factor_spike_ref(*j64[:5])
        assert jfac.sinv.dtype == jnp.float64
        pairs = [(fac64.sinv, jfac.sinv), (fac64.l, jfac.l), (x64, jx)]
        pairs += [(getattr(fs64, n), getattr(jfs, n)) for n in ("v_bot", "v_top", "w_top", "w_bot")]
        pairs += [(fs64.lu.sinv, jfs.lu.sinv)]
        for port, ref in pairs:
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the clustered btf and fused pass (csrc/btf.cu, csrc/fused_spike.cu)
# ---------------------------------------------------------------------------
#
# The kernels run each chain on a cluster of cs CTAs, CTA r owning the rows
# [r R, r R + R), R = ceil(K / cs), of the running block; each forms the
# products for its own rows, and the cluster inverts by panel Gauss-Jordan.
# A numpy float32 model of that bookkeeping, with the inverse by the cluster
# inverse's own model, is held against the Pallas kernels in interpret mode
# and the port's plain versions.  Tolerance: the largest difference at
# most 1e-4 of the largest reference value, the card tests' norm-wise
# limit for the kernels -- the same float32 recurrences with the panel
# inverse's and the products' sums taken in another order, as the kernels
# take them, the rounding amplified by the boosted pivots (a twentieth of
# the block's largest entry) over the block rows.

from test_torch_cyclic_reduction import _panel_gj_inverse  # noqa: E402

CLUSTER_EPS = 0.05  # boosts the zeroed diagonal entries below


def _close_normwise(got, want):
    want = np.asarray(want, dtype=np.float64)
    assert np.abs(np.asarray(got, dtype=np.float64) - want).max() <= 1e-4 * np.abs(want).max()


def _owned(k, cs):
    """The rows each of cs CTAs owns (empty past K)."""
    rows = -(-k // cs)
    return [np.arange(r * rows, min(k, (r + 1) * rows)) for r in range(cs)]


def _invert(slabs, eps):
    """The cluster's inverse of the block its CTAs hold row-wise."""
    return _panel_gj_inverse(np.concatenate(slabs), eps, 32)[0]


def _cluster_btf(d, e, f, cs, eps):
    """btf_cluster_kernel: per chain, S_0 = D_0; per block row each CTA's
    rows of L_j = E_j inv(S_{j-1}) and of S_j = D_j - L_j F_{j-1}."""
    p, m, k, _ = d.shape
    own = _owned(k, cs)
    sinv, l = np.empty_like(d), np.zeros_like(d)
    for q in range(p):
        sinv[q, 0] = _invert([d[q, 0][o] for o in own], eps)
        for j in range(1, m):
            for o in own:
                l[q, j][o] = e[q, j][o] @ sinv[q, j - 1]
            sinv[q, j] = _invert([d[q, j][o] - l[q, j][o] @ f[q, j - 1] for o in own], eps)
    return sinv, l


def _cluster_fused(d, e, f, bq, cq, cs, eps):
    """fused_cluster_kernel: side 0 is btf's recurrence with the left-spike
    carry by owned rows; side 1 the UL recurrence on flipped views with the
    right-spike carry; the corners by the rows of the last inverse each CTA
    owns, side 1's row i giving output row K-1-i."""
    p, m, k, _ = d.shape
    own = _owned(k, cs)
    sinv, l = _cluster_btf(d, e, f, cs, eps)
    vb, vt, wt, wb = (np.empty_like(bq) for _ in range(4))
    for q in range(p):
        c_w = cq[q]
        for j in range(1, m):
            c_w = np.concatenate([-(l[q, j][o] @ c_w) for o in own])
        c_ul = _invert([d[q, m - 1][::-1, ::-1][o] for o in own], eps)
        c_v = bq[q][::-1]
        for j in range(1, m):
            l_ul = np.concatenate([f[q, m - 1 - j][::-1, ::-1][o] @ c_ul for o in own])
            s = [d[q, m - 1 - j][::-1, ::-1][o] - l_ul[o] @ e[q, m - j][::-1, ::-1] for o in own]
            c_v = np.concatenate([-(l_ul[o] @ c_v) for o in own])
            c_ul = _invert(s, eps)
        for o in own:
            vb[q][o] = sinv[q, m - 1][o] @ bq[q]
            wb[q][o] = sinv[q, m - 1][o] @ c_w
            wt[q][k - 1 - o] = c_ul[o] @ cq[q][::-1]
            vt[q][k - 1 - o] = c_ul[o] @ c_v
    return sinv, l, vb, vt, wt, wb


def _cluster_chain(k, seed):
    """Three partitions of three block rows, the last all identity padding;
    random parts scaled by 1/sqrt(K) beside 4 I, and zeroed diagonal
    entries in the first partition, which the boost at CLUSTER_EPS lifts."""
    rng = np.random.default_rng(seed)
    p, m, sc = 3, 3, k**-0.5
    d = sc * rng.normal(size=(p, m, k, k)) + 4 * np.eye(k)
    e, f = (0.3 * sc * rng.normal(size=(p, m, k, k)) for _ in range(2))
    e[:, 0] = f[:, m - 1] = 0.0
    boosted = [1, k // 3, k - 2]
    d[0][:, boosted, boosted] = 0.0
    b_cpl, c_cpl = (0.3 * sc * rng.normal(size=(p - 1, k, k)) for _ in range(2))
    d[-1], e[-1], f[-1] = np.eye(k), 0.0, 0.0
    b_cpl[-1] = c_cpl[-1] = 0.0
    return tuple(x.astype(np.float32) for x in (d, e, f, b_cpl, c_cpl))


@pytest.mark.parametrize("k", [7, 40])
@pytest.mark.parametrize("cs", [1, 2, 3, 16])
def test_clustered_btf_model_matches_interpret_kernel_and_plain(cs, k):
    d, e, f, _, _ = _cluster_chain(k, seed=50 + k + cs)
    sinv, l = _cluster_btf(d, e, f, cs, CLUSTER_EPS)
    ref = jops.block_tridiag_factor(*(jnp.asarray(x) for x in (d, e, f)), CLUSTER_EPS,
                                    impl="interpret")
    plain = tbl.btf_ref(_t(d), _t(e), _t(f), CLUSTER_EPS)
    unboosted = tbl.btf_ref(_t(d), _t(e), _t(f), 0.0)
    assert not torch.allclose(plain.sinv[0], unboosted.sinv[0])  # a pivot was boosted
    for got, jax_ref, torch_ref in ((sinv, ref.sinv, plain.sinv), (l, ref.l, plain.l)):
        _close_normwise(got, jax_ref)
        _close_normwise(got, torch_ref.numpy())
    # the all-padding partition inverts to the identity exactly
    np.testing.assert_array_equal(sinv[-1], np.broadcast_to(np.eye(k, dtype=np.float32), sinv[-1].shape))
    np.testing.assert_array_equal(l[-1], 0.0)


@pytest.mark.parametrize("k", [7, 40])
@pytest.mark.parametrize("cs", [1, 2, 3, 16])
def test_clustered_fused_model_matches_interpret_kernel_and_plain(cs, k):
    d, e, f, b_cpl, c_cpl = _cluster_chain(k, seed=60 + k + cs)
    bq, cq = (x.numpy() for x in tbl.pad_couplings(_t(b_cpl), _t(c_cpl), d.shape[0]))
    got = _cluster_fused(d, e, f, bq, cq, cs, CLUSTER_EPS)
    plain = tbl.fused_factor_spike_padded_ref(*(_t(x) for x in (d, e, f, bq, cq)), CLUSTER_EPS)
    for g, w in zip(got, plain):
        _close_normwise(g, w.numpy())
    ref = jops.fused_factor_spike(*(jnp.asarray(x) for x in (d, e, f, b_cpl, c_cpl)), CLUSTER_EPS,
                                  impl="interpret")
    sinv, l, vb, vt, wt, wb = got
    for g, w in ((sinv, ref.lu.sinv), (l, ref.lu.l), (vb[:-1], ref.v_bot), (vt[:-1], ref.v_top),
                 (wt[1:], ref.w_top), (wb[1:], ref.w_bot)):
        _close_normwise(g, w)
    np.testing.assert_array_equal(sinv[-1], np.broadcast_to(np.eye(k, dtype=np.float32), sinv[-1].shape))
    # the padding partition's couplings are zero, so are its corners
    for corner in (vb[-1], wt[-1]):
        np.testing.assert_array_equal(corner, 0.0)


# ---------------------------------------------------------------------------
# the cluster sweep of bts (csrc/bts.cu, bts_cluster_kernel)
# ---------------------------------------------------------------------------
#
# Each chain runs on a cluster of cs CTAs, CTA r owning the rows [r n,
# r n + n), n = ceil(K / cs), of every block.  The sweep is 3M - 2
# products in the kernel's order -- L_{t+1} (t < M-1), Sinv_{M-1}, then
# F_j and Sinv_j for j = M-2 .. 0 -- each CTA forming its rows of the
# product's output from the whole vector in slot t % 2, the base (b_{t+1},
# or y_j still held in x_j) subtracted, the rows written to x (not T) and
# pushed into every CTA's slot (t + 1) % 2.  A numpy float32 model of that
# bookkeeping is held against the Pallas kernels in interpret mode and the
# plain version, with the cluster kernels' norm-wise tolerance (1e-4 of
# the largest reference value).


def _cluster_bts(sinv, l, f, b, cs):
    p, m, k, r = b.shape
    own = _owned(k, cs)
    x = np.empty_like(b)
    for q in range(p):
        slots = [b[q, 0].copy(), np.zeros((k, r), np.float32)]
        x[q, 0] = b[q, 0]
        for t in range(3 * m - 2):
            if t < m - 1:
                blk, base, out = l[q, t + 1], b[q, t + 1], t + 1
            elif t == m - 1:
                blk, base, out = sinv[q, m - 1], None, m - 1
            else:
                u = t - m
                j = m - 2 - u // 2
                blk, base, out = (f[q, j], x[q, j], None) if u % 2 == 0 else (sinv[q, j], None, j)
            vin, vout = slots[t % 2], slots[(t + 1) % 2]
            for o in own:
                val = blk[o] @ vin if base is None else base[o] - blk[o] @ vin
                if out is not None:
                    x[q, out][o] = val
                vout[o] = val
    return x


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("k", [7, 40])
@pytest.mark.parametrize("cs", [1, 2, 3, 16])
def test_clustered_bts_model_matches_interpret_kernel_and_plain(cs, k, m):
    rng = np.random.default_rng(70 + cs + k + m)
    sc = k**-0.5
    sinv = (sc * rng.normal(size=(2, m, k, k))).astype(np.float32)
    l, f = ((0.3 * sc * rng.normal(size=(2, m, k, k))).astype(np.float32) for _ in range(2))
    b = rng.normal(size=(2, m, k, 4)).astype(np.float32)
    got = _cluster_bts(sinv, l, f, b, cs)
    jfac = jbl.BTFactors(*(jnp.asarray(t) for t in (sinv, l, f)))
    _close_normwise(got, jops.block_tridiag_solve(jfac, jnp.asarray(b), impl="interpret"))
    _close_normwise(got, tbl.bts_ref(tbl.BTFactors(_t(sinv), _t(l), _t(f)), _t(b)).numpy())
