"""The port's SaP-scan recurrences (WKV6, SSD) against the JAX package.

The kernel wrappers' CPU path and ``repro_torch.kernels.ops.wkv6/ssd``
(the chunked plain versions the CUDA kernels compute) against
``repro.kernels.ops.wkv6/ssd`` with ``impl="interpret"`` (the Pallas
kernels run in interpret mode) and against the JAX package's sequential
oracles ``ref.wkv6_ref`` / ``ref.ssd_ref``; the port's sequential oracles
against the JAX ones; chunk = 1 (the decode path), state carry across
calls, strong decay, heads sharing B and C, and the chunk check.  The
card's step and split routes reorder the arithmetic: that order is written
once below in plain PyTorch (``_wkv_routes``, ``_ssd_routes``) and held
against the interpret kernels.

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


# ---------------------------------------------------------------------------
# The card routes' order of arithmetic (csrc/wkv.cu, csrc/ssd.cu,
# csrc/scan.cuh), on flattened (batch x head) rows.  Chunk 1 is the step
# route: the state updated token by token.  Otherwise the split route: every
# chunk's local work at once (the intra output, the chunk's state
# contribution dS and its decay), then the carry along each row, which adds
# the inter term chunk by chunk.  WKV's intra weights off the diagonal
# sub-blocks of 16 are factored through the last row ``ref`` of s's
# sub-chunk: e^{Lprev_t - Lcum_s} = e^{Lprev_t - Lcum_ref} e^{Lcum_ref - Lcum_s}.
# ---------------------------------------------------------------------------

SUB = 16  # csrc/wkv.cu: kSub


def _wkv_routes(r, k, v, logw, u, s0, chunk):
    bh, t, d = r.shape
    if chunk == 1:
        s, outs = s0, []
        for i in range(t):
            rt, kt, vt = r[:, i], k[:, i], v[:, i]
            bonus = (rt * u * kt).sum(-1, keepdim=True)
            outs.append(torch.einsum("bd,bde->be", rt, s) + bonus * vt)
            s = torch.exp(logw[:, i])[..., None] * s + kt[..., None] * vt[:, None]
        return torch.stack(outs, 1), s
    nc = t // chunk
    rc, kc, vc, lc = (a.reshape(bh, nc, chunk, d) for a in (r, k, v, logw))
    lcum = torch.cumsum(lc, 2)
    lprev = torch.cat([torch.zeros_like(lcum[:, :, :1]), lcum[:, :, :-1]], 2)
    g = torch.zeros(bh, nc, chunk, chunk)
    for i0 in range(0, chunk, SUB):
        ti = slice(i0, min(i0 + SUB, chunk))
        m = ti.stop - i0
        below = torch.tril(torch.ones(m, m, dtype=torch.bool), -1)[:, :, None]
        diff = lprev[:, :, ti, None, :] - lcum[:, :, None, ti, :]
        g[:, :, ti, ti] = torch.einsum("bctd,bcsd,bctsd->bcts", rc[:, :, ti], kc[:, :, ti],
                                       torch.exp(torch.where(below, diff, -torch.inf)))
        for j0 in range(0, i0, SUB):
            sj, ref = slice(j0, j0 + SUB), slice(j0 + SUB - 1, j0 + SUB)
            rt = rc[:, :, ti] * torch.exp(lprev[:, :, ti] - lcum[:, :, ref])
            kt = kc[:, :, sj] * torch.exp(lcum[:, :, ref] - lcum[:, :, sj])
            g[:, :, ti, sj] = rt @ kt.transpose(-1, -2)
    bonus = (rc * u[:, None, None] * kc).sum(-1, keepdim=True)
    o_intra = g @ vc + bonus * vc
    ds = (kc * torch.exp(lcum[:, :, -1:] - lcum)).transpose(-1, -2) @ vc
    rh, el = rc * torch.exp(lprev), torch.exp(lcum[:, :, -1])
    s, outs = s0, []
    for j in range(nc):
        outs.append(rh[:, j] @ s + o_intra[:, j])
        s = el[:, j, :, None] * s + ds[:, j]
    return torch.cat(outs, 1), s


def _ssd_routes(x, b, c, loga, s0, chunk, hshare):
    b, c = b.repeat_interleave(hshare, 0), c.repeat_interleave(hshare, 0)
    bh, t, p = x.shape
    n = b.shape[-1]
    if chunk == 1:
        s, ys = s0, []
        for i in range(t):
            ea, cb = torch.exp(loga[:, i])[:, None], (c[:, i] * b[:, i]).sum(-1, keepdim=True)
            ys.append(ea * torch.einsum("bn,bnp->bp", c[:, i], s) + cb * x[:, i])
            s = ea[..., None] * s + b[:, i, :, None] * x[:, i, None]
        return torch.stack(ys, 1), s
    nc = t // chunk
    xc, lc = x.reshape(bh, nc, chunk, p), loga.reshape(bh, nc, chunk)
    bc, cc = b.reshape(bh, nc, chunk, n), c.reshape(bh, nc, chunk, n)
    lcum = torch.cumsum(lc, -1)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    diff = lcum[..., :, None] - lcum[..., None, :]
    g = (cc @ bc.transpose(-1, -2)) * torch.exp(torch.where(mask, diff, -torch.inf))
    y_intra = g @ xc
    ds = (bc * torch.exp(lcum[..., -1:] - lcum)[..., None]).transpose(-1, -2) @ xc
    ea = torch.exp(lcum)
    s, ys = s0, []
    for j in range(nc):
        ys.append(ea[:, j, :, None] * (cc[:, j] @ s) + y_intra[:, j])
        s = ea[:, j, -1, None, None] * s + ds[:, j]
    return torch.cat(ys, 1), s


# (t, chunk, strong): the split route at chunk 16 (one sub-chunk), 64 (four)
# and the ragged 37 (sub-chunks of 16, 16, 5); the step route at chunk 1
# with T > 1; strong decay (log w = log a = -30) at 16 and 64.
ROUTE_CASES = [(64, 16, False), (64, 64, False), (74, 37, False), (8, 1, False),
               (64, 16, True), (64, 64, True)]


@pytest.mark.parametrize("t,chunk,strong", ROUTE_CASES)
def test_wkv_route_order_matches_interpret_kernel(t, chunk, strong):
    b, h, d = 1, 2, 8
    arrs = _wkv_inputs(b, h, t, d, seed=t + chunk, strong=strong)
    r, k, v, lw, u, s0 = map(torch.tensor, arrs)
    flat = lambda a: a.reshape(b * h, *a.shape[2:])  # noqa: E731
    o, s = _wkv_routes(flat(r), flat(k), flat(v), flat(lw), u.repeat(b, 1), flat(s0), chunk)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    want = jops.wkv6(*map(jnp.asarray, arrs), chunk=chunk, impl="interpret")
    _close((o.reshape(b, h, t, d), s.reshape(b, h, d, d)), want)


@pytest.mark.parametrize("t,chunk,strong", ROUTE_CASES)
@pytest.mark.parametrize("shared", [False, True])
def test_ssd_route_order_matches_interpret_kernel(t, chunk, strong, shared):
    b, h, n, p = 2, 3, 8, 8
    x, bm, cm, la, s0 = _ssd_inputs(b, h, t, n, p, seed=t + chunk)
    if strong:
        la = np.full_like(la, -30.0)
    if shared:  # B and C shared by the heads: the route gets them once per batch row
        bm, cm = bm[:, :1].repeat(h, axis=1), cm[:, :1].repeat(h, axis=1)
    hshare = h if shared else 1
    flat = lambda a: torch.tensor(a).reshape(b * h, *a.shape[2:])  # noqa: E731
    once = lambda a: torch.tensor(a[:, ::hshare]).reshape(b * h // hshare, t, n)  # noqa: E731
    y, s = _ssd_routes(flat(x), once(bm), once(cm), flat(la), flat(s0), chunk, hshare)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    want = jops.ssd(*map(jnp.asarray, (x, bm, cm, la, s0)), chunk=chunk, impl="interpret")
    _close((y.reshape(b, h, t, p), s.reshape(b, h, n, p)), want)


def test_scan_routes_follow_the_shape():
    """The wrappers' route rule: chunk 1 steps, chunks up to 64 split, and
    a state dimension above 64 or off a multiple of 4, or a longer chunk,
    keeps the one-block kernel."""
    from repro_torch.kernels.wkv import scan_route

    assert scan_route(1, 64) == "step" and scan_route(1, 64, 64) == "step"
    assert scan_route(64, 64) == "split" and scan_route(37, 8, 16) == "split"
    assert scan_route(128, 64) == "block" and scan_route(16, 72) == "block"
    assert scan_route(16, 6) == "block" and scan_route(1, 64, 66) == "block"
