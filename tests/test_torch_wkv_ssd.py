"""The port's SaP-scan recurrences (WKV6, SSD) against the JAX package.

The kernel wrappers' CPU path and ``repro_torch.kernels.ops.wkv6/ssd``
(the chunked plain versions the CUDA kernels compute) against
``repro.kernels.ops.wkv6/ssd`` with ``impl="interpret"`` (the Pallas
kernels run in interpret mode) and against the JAX package's sequential
oracles ``ref.wkv6_ref`` / ``ref.ssd_ref``; the port's sequential oracles
against the JAX ones; chunk = 1 (the decode path), state carry across
calls, strong decay, heads sharing B and C, and the chunk check.

Tolerance: rtol = atol = 2e-4, the JAX package's own kernel tests' -- the
same float32 recurrence with the cumulative decays and the products' sums
taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd import ssd as ssd_wrapper
from repro_torch.kernels.wkv import wkv6 as wkv_wrapper

TOL = dict(rtol=2e-4, atol=2e-4)


def _wkv_inputs(b, h, t, d, seed, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))
    if strong:
        logw = np.full((b, h, t, d), -30.0, np.float32)
    else:
        logw = -np.exp(rng.normal(size=(b, h, t, d)) * 0.5).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, d, d)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _ssd_inputs(b, h, t, n, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, t, p)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, h, t, n)).astype(np.float32) for _ in range(2))
    la = -np.exp(rng.normal(size=(b, h, t)) * 0.5).astype(np.float32)
    s0 = (rng.normal(size=(b, h, n, p)) * 0.1).astype(np.float32)
    return x, bm, cm, la, s0


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("b,h,t,d,chunk", [(1, 1, 32, 8, 8), (2, 3, 64, 16, 16), (2, 2, 8, 8, 1),
                                           (1, 2, 96, 8, 32), (2, 2, 24, 16, 24)])
def test_wkv6_matches_interpret_kernel_and_sequential_oracle(b, h, t, d, chunk):
    arrs = _wkv_inputs(b, h, t, d, seed=t + d)
    got = ops.wkv6(*map(torch.tensor, arrs), chunk=chunk)
    _close(got, jops.wkv6(*map(jnp.asarray, arrs), chunk=chunk, impl="interpret"))
    _close(got, jref.wkv6_ref(*map(jnp.asarray, arrs)))


def test_bfloat16_scan_tensors_follow_the_interpret_kernels():
    """scan_dtype="bfloat16" on the CPU: the plain versions compute in
    float32 and return the output in the inputs' dtype, as the Pallas
    kernels do (tolerance: bfloat16 rounding of the output, 1e-2)."""
    arrs = _wkv_inputs(1, 2, 32, 8, seed=8)
    bf = [torch.tensor(a).bfloat16() if i < 4 else torch.tensor(a) for i, a in enumerate(arrs)]
    o, s = ops.wkv6(*bf, chunk=16)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    want = jops.wkv6(*(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) if i < 4
                       else jnp.asarray(a.numpy()) for i, a in enumerate(bf)),
                     chunk=16, impl="interpret")
    _close((o.float(), s), [np.asarray(w, np.float32) for w in want], dict(rtol=1e-2, atol=1e-2))
    x, bm, cm, la, s0 = _ssd_inputs(1, 2, 32, 4, 8, seed=9)
    xs = [torch.tensor(a).bfloat16() for a in (x, bm, cm)]
    y, s = ops.ssd(*xs, torch.tensor(la), torch.tensor(s0), chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want = jops.ssd(*(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in xs),
                    jnp.asarray(la), jnp.asarray(s0), chunk=16, impl="interpret")
    _close((y.float(), s), [np.asarray(w, np.float32) for w in want], dict(rtol=1e-2, atol=1e-2))


def test_wkv6_sequential_oracles_agree():
    arrs = _wkv_inputs(2, 2, 16, 8, seed=1)
    _close(ref.wkv6_ref(*map(torch.tensor, arrs)), jref.wkv6_ref(*map(jnp.asarray, arrs)))


def test_wkv6_strong_decay_stays_finite():
    """log w = -30 over a chunk of 16: every exponent of the chunked form
    is <= 0, so the plain version stays finite (and equals the interpret
    kernel) where the JAX jnp chunked oracle returns NaN."""
    arrs = _wkv_inputs(1, 2, 64, 8, seed=3, strong=True)
    o, s = ops.wkv6(*map(torch.tensor, arrs), chunk=16)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    _close((o, s), jops.wkv6(*map(jnp.asarray, arrs), chunk=16, impl="interpret"))
    jo, _ = jops.wkv6(*map(jnp.asarray, arrs), chunk=16, impl="jnp")
    assert not bool(jnp.all(jnp.isfinite(jo)))  # the reference's fault, kept in view


def test_wkv6_state_carries_across_calls():
    r, k, v, logw, u, s0 = map(torch.tensor, _wkv_inputs(1, 2, 64, 8, seed=5))
    o_full, s_full = ops.wkv6(r, k, v, logw, u, s0, chunk=16)
    half = lambda a, sl: a[:, :, sl]  # noqa: E731
    o1, s1 = ops.wkv6(*(half(a, slice(0, 32)) for a in (r, k, v, logw)), u, s0, chunk=16)
    o2, s2 = ops.wkv6(*(half(a, slice(32, 64)) for a in (r, k, v, logw)), u, s1, chunk=1)
    torch.testing.assert_close(torch.cat([o1, o2], dim=2), o_full, **TOL)
    torch.testing.assert_close(s2, s_full, **TOL)


@pytest.mark.parametrize("b,h,t,n,p,chunk", [(1, 1, 32, 4, 8, 8), (2, 2, 64, 8, 16, 16),
                                             (2, 3, 8, 8, 8, 1), (1, 3, 96, 16, 8, 32)])
def test_ssd_matches_interpret_kernel_and_sequential_oracle(b, h, t, n, p, chunk):
    arrs = _ssd_inputs(b, h, t, n, p, seed=t + n)
    got = ops.ssd(*map(torch.tensor, arrs), chunk=chunk)
    _close(got, jops.ssd(*map(jnp.asarray, arrs), chunk=chunk, impl="interpret"))
    _close(got, jref.ssd_ref(*map(jnp.asarray, arrs)))
    _close(ref.ssd_ref(*map(torch.tensor, arrs)), jref.ssd_ref(*map(jnp.asarray, arrs)))


def test_ssd_heads_sharing_b_and_c_reach_the_wrapper_once_per_row(monkeypatch):
    """B and C expanded over the heads (stride 0, as Zamba2 builds them) go
    to the kernel wrapper once per batch row with hshare = H; the result
    equals the materialized per-head form and the JAX interpret kernel."""
    x, bm, cm, la, s0 = _ssd_inputs(2, 4, 32, 8, 16, seed=7)
    bm, cm = bm[:, :1].repeat(4, axis=1), cm[:, :1].repeat(4, axis=1)
    seen = []

    def spy(x, b, c, loga, state, chunk, hshare):
        seen.append((tuple(b.shape), hshare))
        return ssd_wrapper(x, b, c, loga, state, chunk, hshare)

    monkeypatch.setattr(ops, "_ssd", spy)
    bt, ct = (torch.tensor(a[:, :1]).expand(2, 4, 32, 8) for a in (bm, cm))
    got = ops.ssd(torch.tensor(x), bt, ct, torch.tensor(la), torch.tensor(s0), chunk=16)
    assert seen == [((2, 32, 8), 4)]
    want = ops.ssd(*map(torch.tensor, (x, bm, cm, la, s0)), chunk=16)
    assert seen[1] == ((8, 32, 8), 1)
    _close(got, [w.numpy() for w in want], dict(rtol=0, atol=0))
    _close(got, jops.ssd(*map(jnp.asarray, (x, bm, cm, la, s0)), chunk=16, impl="interpret"))


def test_ssd_state_carries_across_calls():
    x, bm, cm, la, s0 = map(torch.tensor, _ssd_inputs(1, 2, 64, 8, 8, seed=5))
    y_full, s_full = ops.ssd(x, bm, cm, la, s0, chunk=16)
    y1, s1 = ops.ssd(x[:, :, :32], bm[:, :, :32], cm[:, :, :32], la[:, :, :32], s0, chunk=16)
    y2, s2 = ops.ssd(x[:, :, 32:], bm[:, :, 32:], cm[:, :, 32:], la[:, :, 32:], s1, chunk=1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y_full, **TOL)
    torch.testing.assert_close(s2, s_full, **TOL)


def test_chunk_must_tile_the_sequence():
    r, k, v, logw, u, s0 = map(torch.tensor, _wkv_inputs(1, 1, 96, 8, seed=0))
    with pytest.raises(ValueError, match="chunk=64"):
        ops.wkv6(r, k, v, logw, u, s0, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        wkv_wrapper(r[0], k[0], v[0], logw[0], u, s0[0], chunk=0)
    x, bm, cm, la, s0 = map(torch.tensor, _ssd_inputs(1, 2, 96, 4, 8, seed=0))
    with pytest.raises(ValueError, match="chunk=64"):
        ops.ssd(x, bm, cm, la, s0, chunk=64)
    with pytest.raises(ValueError, match="hshare"):
        ssd_wrapper(x[0], bm[0], cm[0], la[0], s0[0], chunk=32, hshare=3)
