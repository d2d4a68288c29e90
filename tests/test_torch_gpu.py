"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; run them on a machine with a card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.  Each
test skips inside the ``cuda`` fixture when there is no card, so every
pytest worker collects the same tests.

Tolerance: the largest difference at most 1e-4 of the largest plain value
-- the same float32 recurrences with the K x K product sums taken in
another order, compounding over the M block rows.  The flash kernel's
bfloat16 outputs are held element by element: both sides compute in
float32 and round once, so they differ by at most one bfloat16 step
where the float32 values straddle a rounding boundary -- |got - want| <=
2^-7 |want| (a step is 2^-8 to 2^-7 of the value) plus 1e-5 of the
largest plain value for the float32 difference before the rounding.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SaPOptions, band_to_block_tridiag, factor, plan_banded, random_banded
from repro_torch.core import block_lu as bl
from repro_torch.core.block_lu import compute_dtype
from repro_torch.kernels import ops
from repro_torch.kernels._launch import entry
from repro_torch.kernels.btf import btf
from repro_torch.kernels.bts import bts
from repro_torch.kernels.fused_spike import fused_factor_spike

pytestmark = pytest.mark.gpu

# (n, k, p).  At K = 256 the K x K block does not fit in one CTA's shared
# memory, so btf and the fused pass spread it over a cluster of at least two.
SHAPES = [(15, 5, 4), (259, 37, 3), (3200, 20, 8), (12800, 200, 4), (1400, 256, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(kernel, plain):
    assert bool(torch.isfinite(kernel).all())
    diff = (kernel.double() - plain.double()).abs().max()
    assert float(diff) <= 1e-4 * max(float(plain.double().abs().max()), 1e-30)


def _close_bf16(kernel, plain, atol=1e-5):
    assert bool(torch.isfinite(kernel).all())
    got, want = kernel.double(), plain.double()
    limit = 2.0**-7 * want.abs() + atol * float(want.abs().max())
    assert bool(((got - want).abs() <= limit).all())


def _split(cuda, n, k, p):
    band = torch.tensor(random_banded(n, k, 1.0, seed=n).astype(np.float32), device=cuda)
    return band_to_block_tridiag(band, k, p)


@pytest.mark.parametrize("n,k,p", SHAPES)
def test_btf_kernel_matches_plain(cuda, n, k, p):
    bt = _split(cuda, n, k, p)
    before = btf.launches
    sinv, l = btf(bt.d, bt.e, bt.f)
    assert btf.launches == before + 1
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    _close(sinv, ref.sinv)
    _close(l, ref.l)


@pytest.mark.parametrize("n,k,p", SHAPES)
@pytest.mark.parametrize("r", [1, 4, "k"])
def test_bts_kernel_matches_plain(cuda, n, k, p, r):
    bt = _split(cuda, n, k, p)
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    rhs = torch.randn(bt.d.shape[:3] + (k if r == "k" else r,), device=cuda)
    _close(bts(ref.sinv, ref.l, bt.f, rhs), bl.bts_ref(ref, rhs))


@pytest.mark.parametrize("n,k,p", SHAPES)
def test_fused_kernel_matches_plain(cuda, n, k, p):
    bt = _split(cuda, n, k, p)
    bq, cq = bl.pad_couplings(bt.b_cpl, bt.c_cpl, p)
    for got, want in zip(fused_factor_spike(bt.d, bt.e, bt.f, bq, cq),
                         bl.fused_factor_spike_padded_ref(bt.d, bt.e, bt.f, bq, cq)):
        _close(got, want)


def test_chain_kernels_at_block_size_400(cuda):
    """The SaP-E reduced chain factors 2K x 2K = 400 x 400 blocks, whose
    elimination works out of device memory."""
    bt = _split(cuda, 8 * 7 * 200, 200, 8)
    fs = ops.fused_factor_spike(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    from repro_torch.core.spike import _reduced_interface_system

    rd, re, rf = _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
    got = ops.block_tridiag_factor_chain(rd, re, rf)
    want = bl.btf_chain(rd, re, rf)
    _close(got.sinv, want.sinv)
    h = torch.randn(rd.shape[0], 400, 1, device=cuda)
    _close(ops.block_tridiag_solve_chain(got, h), bl.bts_chain(want, h))


def _btf_on(cuda, d, e, f, cluster):
    """btf through the C entry point on a forced route: a cluster of that
    many CTAs, or the one-block kernel (0)."""
    from repro_torch.kernels import build

    lib = build.load("btf")
    p, m, k, _ = d.shape
    sinv, l = torch.empty_like(d), torch.empty_like(d)
    ws = torch.empty(max(1, p * entry(lib, "btf_workspace_floats", d.dtype)(k, cluster)),
                     dtype=compute_dtype(d.dtype), device=cuda)
    code = entry(lib, "btf_launch", d.dtype)(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), sinv.data_ptr(), l.data_ptr(), ws.data_ptr(),
        p, m, k, bl.DEFAULT_BOOST, cluster, torch.cuda.current_stream(cuda).cuda_stream)
    build.check(lib, code, f"btf (cluster {cluster})")
    return sinv, l


def _fused_on(cuda, d, e, f, bq, cq, cluster):
    from repro_torch.kernels import build

    lib = build.load("fused_spike")
    p, m, k, _ = d.shape
    outs = [torch.empty_like(d), torch.empty_like(d)] + [torch.empty_like(bq) for _ in range(4)]
    ws = torch.empty(max(1, p * entry(lib, "fused_workspace_floats", d.dtype)(k, cluster)),
                     dtype=compute_dtype(d.dtype), device=cuda)
    code = entry(lib, "fused_launch", d.dtype)(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), bq.data_ptr(), cq.data_ptr(),
        *[o.data_ptr() for o in outs], ws.data_ptr(), p, m, k, bl.DEFAULT_BOOST, cluster,
        torch.cuda.current_stream(cuda).cuda_stream)
    build.check(lib, code, f"fused (cluster {cluster})")
    return outs


@pytest.mark.parametrize("n,k,p", [(259, 37, 3), (3200, 20, 8), (12800, 200, 4)])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cluster_kernels_at_every_cluster_size(cuda, n, k, p, cluster):
    """btf and the fused pass forced onto each cluster size the route can
    pick (K = 37 on 16 CTAs leaves three of them no rows)."""
    bt = _split(cuda, n, k, p)
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    sinv, l = _btf_on(cuda, bt.d, bt.e, bt.f, cluster)
    torch.cuda.synchronize()
    _close(sinv, ref.sinv)
    _close(l, ref.l)
    bq, cq = bl.pad_couplings(bt.b_cpl, bt.c_cpl, p)
    for got, want in zip(_fused_on(cuda, bt.d, bt.e, bt.f, bq, cq, cluster),
                         bl.fused_factor_spike_padded_ref(bt.d, bt.e, bt.f, bq, cq)):
        _close(got, want)


def _bts_on(cuda, facs, b, cluster):
    """bts through the C entry point on a forced route: a cluster of that
    many CTAs, or the one-block kernel (0).  Returns (x, CUDA error code)."""
    from repro_torch.kernels import build

    lib = build.load("bts")
    p, m, k, r = b.shape
    x = torch.empty_like(b)
    ws = torch.empty(max(1, p * entry(lib, "bts_workspace_floats", b.dtype)(m, k, r, cluster)),
                     dtype=compute_dtype(b.dtype), device=cuda)
    code = entry(lib, "bts_launch", b.dtype)(
        facs.sinv.data_ptr(), facs.l.data_ptr(), facs.f.data_ptr(), b.data_ptr(), x.data_ptr(),
        ws.data_ptr(), p, m, k, r, cluster, torch.cuda.current_stream(cuda).cuda_stream)
    return x, code


# (n, k, p): K % 4 == 0 (TMA bulk copies: 20, 200) and not (cp.async: 37,
# 95); K = 37 on 16 CTAs leaves three of them no rows; K = 95 is the
# sparse run's reordered band
BTS_ROUTE_SHAPES = [(259, 37, 3), (3200, 20, 8), (12800, 200, 4), (2280, 95, 4)]


@pytest.mark.parametrize("n,k,p", BTS_ROUTE_SHAPES)
@pytest.mark.parametrize("r", [1, 4, "k"])
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8, 16])
def test_bts_at_every_cluster_size_and_copy_route(cuda, n, k, p, r, cluster):
    """bts forced onto each cluster size (0: the one-block kernel) against
    its plain version; R = K > 8 has only the one-block kernel, and a
    cluster launch of it is refused with an error, never run elsewhere."""
    from repro_torch.kernels import build

    bt = _split(cuda, n, k, p)
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    rr = k if r == "k" else r
    b = torch.randn(bt.d.shape[:3] + (rr,), device=cuda)
    lib = build.load("bts")
    assert lib.bts_bulk_route(ref.sinv.data_ptr(), ref.l.data_ptr(), bt.f.data_ptr(), k) == (
        k % 4 == 0)
    x, code = _bts_on(cuda, ref, b, cluster)
    if rr > 8 and cluster > 0:
        assert code != 0
        return
    build.check(lib, code, f"bts (cluster {cluster})")
    torch.cuda.synchronize()
    _close(x, bl.bts_ref(ref, b))


def test_bts_block_launches_are_the_wide_rhs_only(cuda):
    """Through the wrapper: R <= 8 takes a cluster (counted by size), R = K
    the one-block kernel, counted in ``bts.block_launches``."""
    from repro_torch.kernels import build

    bt = _split(cuda, 12800, 200, 4)
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    lib = build.load("bts")
    for r, cs in ((1, lib.bts_cluster_size(4, 200, 1)), (8, lib.bts_cluster_size(4, 200, 8)),
                  (200, 0)):
        assert (cs == 0) == (r > 8)
        b = torch.randn(bt.d.shape[:3] + (r,), device=cuda)
        before = bts.launches, bts.block_launches, bts.by_cluster.get(cs, 0)
        x = bts(ref.sinv, ref.l, bt.f, b)
        torch.cuda.synchronize()
        assert (bts.launches, bts.block_launches, bts.by_cluster[cs]) == (
            before[0] + 1, before[1] + (r > 8), before[2] + 1)
        _close(x, bl.bts_ref(ref, b))


def test_bts_cluster_size_follows_the_shape(cuda):
    """The shapes of the main path on an H100: 2 CTAs a chain at P = 64,
    16 on SaP-E's P = 8 split and on a single reduced chain, 1 at P = 500."""
    from repro_torch.kernels import build

    lib = build.load("bts")
    sizes = {(p, k): lib.bts_cluster_size(p, k, 1) for p, k in ((64, 200), (8, 200), (1, 400),
                                                               (500, 200))}
    assert sizes == {(64, 200): 2, (8, 200): 16, (1, 400): 16, (500, 200): 1}
    assert lib.bts_cluster_size(4, 200, 9) == 0 and lib.bts_cluster_size(4, 2000, 1) == 0


def test_k256_takes_a_cluster_and_k800_the_one_block_kernel(cuda):
    """K = 256 does not fit one CTA: both kernels take a cluster of at least
    two, no device workspace for btf and four K x K slots a side for the
    fused pass.  K = 800 fits no cluster of 16: the wrappers take the
    one-block kernel (counted in ``block_launches``) and still match."""
    from repro_torch.kernels import build

    lb, lf = build.load("btf"), build.load("fused_spike")
    assert lb.btf_cluster_size(2, 256) >= 2 and lf.fused_cluster_size(2, 256) >= 2
    assert lb.btf_workspace_floats(256, 2) == 0
    assert lf.fused_workspace_floats(256, 2) == 2 * 4 * 256 * 256
    assert lb.btf_cluster_size(1, 800) == 0 and lf.fused_cluster_size(1, 800) == 0
    g = torch.Generator(device=cuda).manual_seed(0)
    k, sc = 800, 800**-0.5
    d = sc * torch.randn(2, 2, k, k, generator=g, device=cuda) + 4 * torch.eye(k, device=cuda)
    e, f = (0.3 * sc * torch.randn(2, 2, k, k, generator=g, device=cuda) for _ in range(2))
    e[:, 0] = 0.0
    f[:, -1] = 0.0
    bq, cq = (0.3 * sc * torch.randn(2, k, k, generator=g, device=cuda) for _ in range(2))
    before = btf.launches, btf.block_launches, fused_factor_spike.block_launches
    sinv, l = btf(d, e, f)
    out = fused_factor_spike(d, e, f, bq, cq)
    torch.cuda.synchronize()
    assert (btf.launches, btf.block_launches, fused_factor_spike.block_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref = bl.btf_ref(d, e, f)
    _close(sinv, ref.sinv)
    _close(l, ref.l)
    for got, want in zip(out, bl.fused_factor_spike_padded_ref(d, e, f, bq, cq)):
        _close(got, want)


def test_kernels_refuse_operands_that_require_grad(cuda):
    """The card kernels have no backward: btf and flash_attention refuse an
    operand that requires grad while grad mode is on, and take it under
    torch.no_grad()."""
    from repro_torch.kernels.flash_attn import flash_attention

    bt = _split(cuda, 64, 4, 2)
    d = bt.d.clone().requires_grad_(True)
    before = btf.launches
    with pytest.raises(ValueError, match="requires grad"):
        btf(d, bt.e, bt.f)
    assert btf.launches == before
    with torch.no_grad():
        sinv, _ = btf(d, bt.e, bt.f)
    _close(sinv, bl.btf_ref(bt.d, bt.e, bt.f).sinv)
    q, k, v = (torch.randn(1, 2, 64, 64, device=cuda) for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


def test_wrappers_reject_non_float32(cuda):
    """bfloat16 and float64 storage run (their own instantiations); float16
    and mixed block dtypes are refused before any launch."""
    bt = _split(cuda, 64, 4, 2)
    before = btf.launches
    with pytest.raises(TypeError, match="float32 or bfloat16 or float64"):
        btf(bt.d.half(), bt.e.half(), bt.f.half())
    with pytest.raises(TypeError, match="one storage dtype"):
        btf(bt.d.double(), bt.e, bt.f)
    assert btf.launches == before


@pytest.mark.parametrize("variant", ["C", "D", "E"])
def test_lifecycle_on_the_card_matches_the_cpu(cuda, variant):
    band = random_banded(4000, 10, 1.0 if variant != "E" else 0.5, seed=1).astype(np.float32)
    b = np.random.default_rng(2).normal(size=4000)
    opts = SaPOptions(p=8, variant=variant, tol=1e-8)
    gpu = factor(plan_banded(band, opts)).solve(b)
    cpu = factor(plan_banded(band, opts, device="cpu")).solve(b)
    assert float(gpu.true_resnorm) <= 1e-6
    x_gpu, x_cpu = gpu.x.cpu(), cpu.x
    assert float((x_gpu - x_cpu).norm() / x_cpu.norm()) <= 1e-5


# ---------------------------------------------------------------------------
# block cyclic reduction
# ---------------------------------------------------------------------------


def _bcr_chain(cuda, m, k, r, seed=0):
    """A well-conditioned chain: random parts scaled by 1/sqrt(K), so the
    4 I shift dominates at every block size."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    s = k**-0.5
    d = s * torch.randn(m, k, k, generator=g, device=cuda) + 4 * torch.eye(k, device=cuda)
    e = 0.3 * s * torch.randn(m, k, k, generator=g, device=cuda)
    f = 0.3 * s * torch.randn(m, k, k, generator=g, device=cuda)
    b = torch.randn(m, k, r, generator=g, device=cuda)
    return d, e, f, b


def _interface_chain(cuda, p):
    """The SaP-E reduced chain of a d = 0.5 band: P-1 blocks of 2K = 400."""
    from repro_torch.core.spike import _reduced_interface_system

    band = torch.tensor(random_banded(p * 2 * 200, 200, 0.5, seed=p).astype(np.float32), device=cuda)
    bt = band_to_block_tridiag(band, 200, p)
    fs = ops.fused_factor_spike(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    return _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)


# (m, K, R): m = 1 (root only), non-powers of two, K = 37, R = K; at
# 2K = 190 (the sparse run's chain) the inverse eliminates in shared
# memory, at 2K = 400 in device memory
BCR_SHAPES = [(1, 8, 1), (3, 6, 2), (5, 37, 37), (16, 20, 4), (7, 190, 4), (9, 400, 1)]


@pytest.mark.parametrize("m,k,r", BCR_SHAPES)
def test_bcr_kernels_match_plain(cuda, m, k, r):
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr

    d, e, f, b = _bcr_chain(cuda, m, k, r)
    pd, pe, pf = cr.pad_chain(d, e, f)
    if pd.shape[0] > 1:
        a_odd = bcr.inv_odd(pd)
        _close(a_odd, cr.bcr_inv_odd_ref(pd))
        for got, want in zip(bcr.reduce(pd, pe, pf, a_odd), cr.bcr_reduce_ref(pd, pe, pf, a_odd)):
            _close(got, want)
        lo, hi = cr.bcr_reduce_ref(pd, pe, pf, a_odd)[:2]
        bp = cr.pad_rhs(b, (pd.shape[0] - 1).bit_length())
        _close(bcr.rhs_reduce(lo, hi, bp), cr.bcr_rhs_reduce_ref(lo, hi, bp))
        x = torch.randn(pd.shape[0] // 2, k, r, device=cuda)
        eo, fo = pe[1::2].contiguous(), pf[1::2].contiguous()
        _close(bcr.backsub(a_odd, eo, fo, bp, x), cr.bcr_backsub_ref(a_odd, eo, fo, bp, x))
    before = bcr.inv_odd.launches
    fac = ops.bcr_factor(d, e, f)
    assert bcr.inv_odd.launches == before + fac.n_levels + 1
    want = cr.bcr_factor(d, e, f)
    _close(fac.root_inv, want.root_inv)
    _close(ops.bcr_solve(fac, b), cr.bcr_solve(want, b))


@pytest.mark.parametrize("p", [9, 16])
def test_bcr_on_the_interface_chain_at_block_size_400(cuda, p):
    """The d = 0.5 reduced chain: the kernel path against the plain BCR, and
    its answer solves the chain (relative residual at most 1e-4, float32
    elimination without pivoting across blocks)."""
    rd, re, rf = _interface_chain(cuda, p)
    fac = ops.bcr_factor(rd, re, rf)
    from repro_torch.core import cyclic_reduction as cr

    want = cr.bcr_factor(rd, re, rf)
    for got_l, want_l in zip(fac.levels, want.levels):
        for got, w in zip(got_l, want_l):
            _close(got, w)
    h = torch.randn(p - 1, 400, 1, device=cuda)
    x = ops.bcr_solve(fac, h)
    _close(x, cr.bcr_solve(want, h))
    ax = rd @ x
    ax[1:] += re[1:] @ x[:-1]
    ax[:-1] += rf[:-1] @ x[1:]
    assert float((ax - h).norm() / h.norm()) <= 1e-4


# (2K, cluster size on an H100, whose blocks may opt in to 232,448 bytes of
# shared memory): one CTA; the P = 64 interface chain's 400 on four; a
# ragged 401; 700, which needs sixteen; 800, too large for a cluster of 16,
# on the one-block kernel in device memory
INV_SIZES = [(190, 1), (400, 4), (401, 4), (700, 16), (800, 0)]


@pytest.mark.parametrize("k,cluster", INV_SIZES)
def test_inv_odd_on_its_cluster_matches_plain(cuda, k, cluster):
    """Three blocks (an odd count) with boosted pivots -- zeroed diagonal
    entries under boost_eps = 0.05, so the boost changes the inverse --
    and, in the middle block, rows and columns that are exactly zero,
    which must invert to the identity; within 1e-4 of the largest plain
    value, one launch, on the route the block size picks."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr, build

    assert build.load("bcr").bcr_inv_cluster_size(k) == cluster
    d = _bcr_chain(cuda, 6, k, 1, seed=k)[0]
    boosted = [1, k // 3, k - 2]
    d[:, boosted, boosted] = 0.0
    zero = [0, k // 2, k - 1]
    d[3, zero, :] = 0.0
    d[3, :, zero] = 0.0
    eps = 0.05
    before = bcr.inv_odd.launches, bcr.inv_odd.block_launches
    got = bcr.inv_odd(d, eps)
    torch.cuda.synchronize()
    assert (bcr.inv_odd.launches, bcr.inv_odd.block_launches) == (
        before[0] + 1, before[1] + (cluster == 0))
    want = cr.bcr_inv_odd_ref(d, eps)
    assert not torch.allclose(want, cr.bcr_inv_odd_ref(d, 0.0))  # a pivot was boosted
    _close(got, want)
    eye = torch.eye(k, device=cuda)
    assert torch.equal(got[1][zero], eye[zero]) and torch.equal(got[1][:, zero], eye[:, zero])


def _reduce_on(d, e, f, a, tile):
    from repro_torch.kernels import build

    lib = build.load("bcr")
    outs = [torch.empty_like(a) for _ in range(5)]
    m2, k = a.shape[0], a.shape[1]
    ws = torch.empty(max(1, entry(lib, "bcr_reduce_workspace_floats", a.dtype)(m2, k)),
                     dtype=compute_dtype(a.dtype), device=a.device)
    code = entry(lib, "bcr_reduce_launch", a.dtype)(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), a.data_ptr(), *[o.data_ptr() for o in outs],
        ws.data_ptr(), m2, k, tile, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, f"bcr reduce (tile {tile})")
    return outs


@pytest.mark.parametrize("m2", [1, 2, 32])
@pytest.mark.parametrize("k", [190, 400])
@pytest.mark.parametrize("tile", [96, 80, 64, 32])
def test_reduce_at_every_tile(cuda, m2, k, tile):
    """reduce forced onto each tile size against its plain version: 2K =
    190 (the sparse run's chain; no tile divides it) and 400 (the P = 64
    and P = 500 chains), m/2 = 1, 2 and 32, with E_0 = 0 as every level's
    chain has it."""
    from repro_torch.core import cyclic_reduction as cr

    d, e, f, _ = _bcr_chain(cuda, 2 * m2, k, 1, seed=m2 + k)
    e[0] = 0.0
    f[-1] = 0.0
    a = _bcr_chain(cuda, m2, k, 1, seed=k)[0]
    for got, want in zip(_reduce_on(d, e, f, a, tile),
                         cr.bcr_reduce_ref(d, e, f, a)):
        _close(got, want)


def test_reduce_tile_follows_the_shape(cuda):
    """On an H100 (132 SMs): the 80-wide tile where it pads 2K = 400 not at
    all and the level gives every SM eight CTAs (m/2 >= 22), else 64; 32
    for K <= 32.  The wrapper counts its launches by tile."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr, build

    lib = build.load("bcr")
    assert [lib.bcr_reduce_tile(m2, 400) for m2 in (256, 32, 16, 1)] == [80, 80, 64, 64]
    assert [lib.bcr_reduce_tile(m2, 190) for m2 in (32, 1)] == [64, 64]
    assert lib.bcr_reduce_tile(4, 20) == 32
    d, e, f, _ = _bcr_chain(cuda, 4, 37, 1)
    e[0] = 0.0
    f[-1] = 0.0
    a = bcr.inv_odd(d)
    before = bcr.reduce.by_tile.get(64, 0)
    for got, want in zip(bcr.reduce(d, e, f, a), cr.bcr_reduce_ref(d, e, f, a)):
        _close(got, want)
    assert bcr.reduce.by_tile[64] == before + 1


# ---- the BCR solve kernels: rhs_reduce and backsub --------------------------


def _rhs_on(lo, hi, b, split):
    """rhs_reduce through the C entry point at a forced split (0: tiled)."""
    from repro_torch.kernels import build

    lib = build.load("bcr")
    out = torch.empty(lo.shape[0], lo.shape[1], b.shape[-1], dtype=b.dtype, device=b.device)
    code = entry(lib, "bcr_rhs_reduce_launch", b.dtype)(
        lo.data_ptr(), hi.data_ptr(), b.data_ptr(), out.data_ptr(), lo.shape[0], lo.shape[1],
        b.shape[-1], split, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, f"bcr rhs_reduce (split {split})")
    return out


def _backsub_on(a, e, f, b, x, cluster):
    """backsub through the C entry point at a forced cluster size (0: the
    tiled kernels, with their workspace)."""
    from repro_torch.kernels import build

    lib = build.load("bcr")
    m2, k, r = x.shape
    t = torch.empty(x.shape, dtype=compute_dtype(x.dtype), device=x.device)
    out = torch.empty(2 * m2, k, r, dtype=x.dtype, device=x.device)
    code = entry(lib, "bcr_backsub_launch", x.dtype)(
        a.data_ptr(), e.data_ptr(), f.data_ptr(), b.data_ptr(), x.data_ptr(),
        t.data_ptr() if cluster == 0 else None, out.data_ptr(), m2, k, r, cluster,
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, f"bcr backsub (cluster {cluster})")
    return out


def _solve_level(cuda, m2, k, r, seed=0):
    """One level's solve operands as the chain gives them: lo_0 = 0 (E_0 = 0)
    and f_odd[m2-1] = 0 (the chain's tail), so the clamped neighbours the
    kernels read are zeroed as in a real level."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    s = k**-0.5
    lo, hi, a, e, f = (s * torch.randn(m2, k, k, generator=g, device=cuda) for _ in range(5))
    lo[0] = 0.0
    f[-1] = 0.0
    b = torch.randn(2 * m2, k, r, generator=g, device=cuda)
    x = torch.randn(m2, k, r, generator=g, device=cuda)
    return lo, hi, a, e, f, b, x


def _routes_taken(call, r):
    """Run ``call`` and assert that its rhs_reduce / backsub calls took the
    warp / cluster routes for R <= 8 and the tiled kernels above (counted
    in ``block_launches``)."""
    from repro_torch.kernels import bcr

    wrappers = (bcr.rhs_reduce, bcr.backsub)
    before = [(w.launches, w.block_launches) for w in wrappers]
    out = call()
    for w, (calls, tiled) in zip(wrappers, before):
        calls, tiled = w.launches - calls, w.block_launches - tiled
        assert tiled == (calls if r > 8 else 0), f"R={r}: {tiled} of {calls} calls tiled"
    return out


@pytest.mark.parametrize("r", [1, 4, 8, 9])
@pytest.mark.parametrize("p", [64, 500])
def test_solve_kernels_at_every_level_of_the_interface_chains(cuda, p, r):
    """rhs_reduce and backsub at every level of the P = 64 and P = 500
    interface chains (63 and 499 blocks of 2K = 400, padded to 64 and 512),
    R = 1, 4, 8 on the warp / cluster routes and R = 9 on the tiled ones;
    then ops.bcr_solve against the plain bcr_solve."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr

    chain = _interface_chain(cuda, p)
    want = cr.bcr_factor(*chain)
    g = torch.Generator(device=cuda).manual_seed(p + r)
    h = torch.randn(p - 1, 400, r, generator=g, device=cuda)
    b = cr.pad_rhs(h, want.n_levels)
    rhs = []
    for lv in want.levels:
        rhs.append(b)
        got = _routes_taken(lambda: bcr.rhs_reduce(lv.lo, lv.hi, b), r)
        b = cr.bcr_rhs_reduce_ref(lv.lo, lv.hi, b)
        _close(got, b)
    x = (want.root_inv @ b[0])[None]
    for lv, bl_ in zip(reversed(want.levels), reversed(rhs)):
        eo, fo = lv.e_odd.contiguous(), lv.f_odd.contiguous()
        got = _routes_taken(lambda: bcr.backsub(lv.a_odd, eo, fo, bl_, x), r)
        x = cr.bcr_backsub_ref(lv.a_odd, eo, fo, bl_, x)
        _close(got, x)
    fac = ops.bcr_factor(*chain)
    _close(ops.bcr_solve(fac, h), cr.bcr_solve(want, h))


# 2K = 37 (4-byte loads), 70 and 190 (8-byte: the sparse run's chain), 400
# (16-byte); m/2 = 1, 2, 3 so that both clamped neighbours are read
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("m2", [1, 2, 3])
@pytest.mark.parametrize("k,vec", [(37, 1), (70, 2), (190, 2), (400, 4)])
def test_solve_kernels_at_every_row_width(cuda, k, vec, m2, r):
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr, build

    lib = build.load("bcr")
    lo, hi, a, e, f, b, x = _solve_level(cuda, m2, k, r, seed=k + m2 + r)
    assert lib.bcr_solve_vec(lo.data_ptr(), hi.data_ptr(), hi.data_ptr(), k) == vec
    assert lib.bcr_solve_vec(a.data_ptr(), e.data_ptr(), f.data_ptr(), k) == vec
    got = _routes_taken(lambda: (bcr.rhs_reduce(lo, hi, b), bcr.backsub(a, e, f, b, x)), r)
    _close(got[0], cr.bcr_rhs_reduce_ref(lo, hi, b))
    _close(got[1], cr.bcr_backsub_ref(a, e, f, b, x))


def test_solve_kernels_take_narrower_loads_off_alignment(cuda):
    """Blocks that start 4 bytes past a 16-byte boundary take 4-byte loads
    at 2K = 400, and still match the plain versions."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr, build

    m2, k, r = 2, 400, 1
    lo, hi, a, e, f, b, x = _solve_level(cuda, m2, k, r)
    shifted = []
    for t in (lo, hi, a, e, f):
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(t.shape))
    lo, hi, a, e, f = shifted
    assert build.load("bcr").bcr_solve_vec(lo.data_ptr(), hi.data_ptr(), hi.data_ptr(), k) == 1
    _close(bcr.rhs_reduce(lo, hi, b), cr.bcr_rhs_reduce_ref(lo, hi, b))
    _close(bcr.backsub(a, e, f, b, x), cr.bcr_backsub_ref(a, e, f, b, x))


@pytest.mark.parametrize("size", [0, 1, 2, 4, 8, 16])
def test_solve_kernels_at_every_forced_size(cuda, size):
    """Both C entry points forced onto each split / cluster size (0: the
    tiled kernels) at m/2 = 2, 2K = 400, R = 1 and 4."""
    from repro_torch.core import cyclic_reduction as cr

    for r in (1, 4):
        lo, hi, a, e, f, b, x = _solve_level(cuda, 2, 400, r, seed=size + r)
        _close(_rhs_on(lo, hi, b, size), cr.bcr_rhs_reduce_ref(lo, hi, b))
        _close(_backsub_on(a, e, f, b, x, size), cr.bcr_backsub_ref(a, e, f, b, x))


def test_solve_launch_shape_rule(cuda):
    """The rule both solve kernels share, on an H100 (132 SMs): the largest
    power of two at which the card holds the whole level at once
    (rhs_reduce: its CTAs, one an SM at 2K = 400, up to 32 a block;
    backsub: its clusters, up to 16 CTAs), each CTA at least 8 rows; 0
    (the tiled kernels) for R > 8.  Warps a CTA: min(rows, 16)."""
    from repro_torch.kernels import build

    lib = build.load("bcr")
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the pinned values are an H100 SXM's (132 SMs)")
    levels = (256, 128, 64, 32, 16, 8, 4, 2, 1)
    assert [lib.bcr_rhs_reduce_split(m2, 400, 1) for m2 in levels] == [1, 1, 2, 4, 8, 16, 32,
                                                                        32, 32]
    assert [lib.bcr_backsub_cluster(m2, 400, 1) for m2 in levels] == [1, 1, 2, 2, 4, 8, 16,
                                                                       16, 16]
    assert [lib.bcr_rhs_reduce_split(m2, 190, 1) for m2 in (32, 16, 1)] == [8, 16, 16]
    assert [lib.bcr_backsub_cluster(m2, 190, 1) for m2 in (32, 16, 1)] == [4, 16, 16]
    assert lib.bcr_rhs_reduce_split(1, 37, 1) == lib.bcr_backsub_cluster(1, 37, 1) == 4
    assert lib.bcr_rhs_reduce_split(1, 400, 9) == lib.bcr_backsub_cluster(1, 400, 9) == 0
    assert [lib.bcr_solve_warps(400, s) for s in (1, 16, 32)] == [16, 16, 13]
    assert lib.bcr_solve_warps(37, 4) == 10
    assert lib.bcr_backsub_max_clusters(400, 1, 16) >= 1


def test_backsub_is_one_grid_without_a_workspace(cuda):
    """At R <= 8 a backsub call launches one kernel (the profiler's count)
    and allocates only its output; rhs_reduce one kernel too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bcr

    lo, hi, a, e, f, b, x = _solve_level(cuda, 4, 400, 1)
    bcr.backsub(a, e, f, b, x)  # built and warm
    bcr.rhs_reduce(lo, hi, b)
    torch.cuda.synchronize()
    for call, out_bytes in ((lambda: bcr.backsub(a, e, f, b, x), b.numel() * 4),
                            (lambda: bcr.rhs_reduce(lo, hi, b), x.numel() * 4)):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1, [ev.name for ev in kernels]
        assert torch.cuda.max_memory_allocated() - base <= -(-out_bytes // 512) * 512
        del out


def test_bcr_wrappers_reject_bad_operands(cuda):
    from repro_torch.kernels import bcr

    d, e, f, b = _bcr_chain(cuda, 4, 8, 1)
    with pytest.raises(TypeError):
        bcr.inv_odd(d.half())
    with pytest.raises(TypeError, match="one storage dtype"):
        bcr.rhs_reduce(d[:2].double(), d[:2], b)
    with pytest.raises(ValueError):
        bcr.reduce(d[:3], e[:3], f[:3], d[:1])


def test_e_bcr_lifecycle_on_the_card_matches_the_cpu(cuda):
    band = random_banded(4000, 10, 0.5, seed=3).astype(np.float32)
    b = np.random.default_rng(4).normal(size=4000)
    opts = SaPOptions(p=16, variant="E", tol=1e-8)
    gpu_fac = factor(plan_banded(band, opts))
    assert gpu_fac.pc.reduced_solver == "bcr"
    gpu = gpu_fac.solve(b)
    cpu = factor(plan_banded(band, opts, device="cpu")).solve(b)
    assert float(gpu.true_resnorm) <= 1e-6
    x_gpu, x_cpu = gpu.x.cpu(), cpu.x
    assert float((x_gpu - x_cpu).norm() / x_cpu.norm()) <= 1e-5


def test_sparse_plan_on_the_card(cuda):
    from repro_torch.core import plan, random_sparse

    csr = random_sparse(3000, 12.0, d=1.0, seed=0, structured_band=20)
    csr.data = csr.data.astype(np.float32).astype(np.float64)
    pl = plan(csr, SaPOptions(p=8, variant="auto", tol=1e-8))
    assert pl.band_pc.device.type == "cuda" and pl.op.data.device.type == "cuda"
    xstar = np.random.default_rng(1).normal(size=3000)
    b = csr.to_dense() @ xstar
    res = factor(pl).solve(b)
    assert float(res.true_resnorm) <= 1e-6
    assert float(np.linalg.norm(res.x.cpu().numpy() - xstar) / np.linalg.norm(xstar)) <= 1e-4


# ---------------------------------------------------------------------------
# the SaP-scan kernels (WKV6, SSD) and the LM path
# ---------------------------------------------------------------------------


# (bh, t, d, chunk): small heads, ragged chunks, and RWKV6-1.6B's head
# width D=64 at decode (T=1) and prefill (chunk 64)
WKV_SHAPES = [(3, 32, 8, 8), (4, 37, 16, 37), (256, 1, 64, 1), (64, 256, 64, 64)]


@pytest.mark.parametrize("bh,t,d,chunk", WKV_SHAPES)
@pytest.mark.parametrize("strong", [False, True])
def test_wkv_kernel_matches_plain(cuda, bh, t, d, chunk, strong):
    from repro_torch.kernels.wkv import wkv6, wkv6_plain

    g = torch.Generator(device=cuda).manual_seed(bh + t)
    r, k, v = (torch.randn(bh, t, d, generator=g, device=cuda) for _ in range(3))
    if strong:  # log w = -30: every exponent stays <= 0, the output finite
        logw = torch.full((bh, t, d), -30.0, device=cuda)
    else:
        logw = -torch.exp(0.5 * torch.randn(bh, t, d, generator=g, device=cuda))
    u = torch.randn(bh, d, generator=g, device=cuda)
    s0 = 0.1 * torch.randn(bh, d, d, generator=g, device=cuda)
    before = wkv6.launches
    o, s = wkv6(r, k, v, logw, u, s0, chunk)
    assert wkv6.launches == before + 1
    want = wkv6_plain(r, k, v, logw, u, s0, chunk)
    _close(o, want[0])
    _close(s, want[1])


# (b, h, t, n, p, chunk, B/C shared by the heads); Zamba2-2.7B's heads
# (H=80, N=P=64) at decode and prefill
SSD_SHAPES = [(2, 3, 32, 4, 8, 8, False), (1, 4, 37, 8, 16, 37, True),
              (8, 80, 1, 64, 64, 1, True), (2, 80, 128, 64, 64, 64, True)]


@pytest.mark.parametrize("b,h,t,n,p,chunk,shared", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, b, h, t, n, p, chunk, shared):
    from repro_torch.kernels.ssd import ssd, ssd_plain

    g = torch.Generator(device=cuda).manual_seed(b * h + t)
    x = torch.randn(b * h, t, p, generator=g, device=cuda)
    hs = h if shared else 1
    bm, cm = (torch.randn(b * h // hs, t, n, generator=g, device=cuda) for _ in range(2))
    la = -torch.exp(0.5 * torch.randn(b * h, t, generator=g, device=cuda))
    s0 = 0.1 * torch.randn(b * h, n, p, generator=g, device=cuda)
    before = ssd.launches
    y, s = ssd(x, bm, cm, la, s0, chunk, hs)
    assert ssd.launches == before + 1
    want = ssd_plain(x, bm, cm, la, s0, chunk, hs)
    _close(y, want[0])
    _close(s, want[1])


def _wkv_args(cuda, bh, t, d, strong=False, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r, k, v = (torch.randn(bh, t, d, generator=g, device=cuda) for _ in range(3))
    if strong:
        logw = torch.full((bh, t, d), -30.0, device=cuda)
    else:
        logw = -torch.exp(0.5 * torch.randn(bh, t, d, generator=g, device=cuda))
    u = torch.randn(bh, d, generator=g, device=cuda)
    return r, k, v, logw, u, 0.1 * torch.randn(bh, d, d, generator=g, device=cuda)


def _ssd_args(cuda, bh, t, n, p, hshare, strong=False, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(bh, t, p, generator=g, device=cuda)
    bm, cm = (torch.randn(bh // hshare, t, n, generator=g, device=cuda) for _ in range(2))
    if strong:
        la = torch.full((bh, t), -30.0, device=cuda)
    else:
        la = -torch.exp(0.5 * torch.randn(bh, t, generator=g, device=cuda))
    return x, bm, cm, la, 0.1 * torch.randn(bh, n, p, generator=g, device=cuda)


# (bh, t, d, chunk, route): the decode step at RWKV6-1.6B's 8 x 32 rows, the
# split route at its prefill (4 x 32 rows, T=512, chunk 64), a ragged chunk,
# rows fewer and many more than the card's 132 SMs, chunk 1 with T > 1, and
# the one-block kernel's shapes (D off a multiple of 4, a chunk of 128)
WKV_ROUTE_SHAPES = [(256, 1, 64, 1, "step"), (128, 512, 64, 64, "split"),
                    (6, 74, 64, 37, "split"), (3, 128, 64, 64, "split"),
                    (1024, 64, 64, 16, "split"), (1000, 1, 64, 1, "step"),
                    (4, 16, 64, 1, "step"), (5, 48, 16, 48, "split"),
                    (4, 32, 6, 16, "block"), (2, 128, 64, 128, "block")]


@pytest.mark.parametrize("bh,t,d,chunk,route", WKV_ROUTE_SHAPES)
@pytest.mark.parametrize("strong", [False, True])
def test_wkv_route_matches_plain(cuda, bh, t, d, chunk, route, strong):
    from repro_torch.kernels.wkv import scan_route, wkv6, wkv6_plain

    assert scan_route(chunk, d) == route
    args = _wkv_args(cuda, bh, t, d, strong, seed=bh + t)
    before = dict(wkv6.by_route)
    o, s = wkv6(*args, chunk)
    assert wkv6.by_route == {**before, route: before[route] + 1}
    want = wkv6_plain(*args, chunk)
    _close(o, want[0])
    _close(s, want[1])


# (b, h, t, n, p, chunk, B/C shared by the heads, route): the decode step at
# Zamba2-2.7B's 8 x 80 rows, the split route at its prefill (4 x 80 rows,
# T=512, chunk 64), a ragged chunk, few and many rows, chunk 1 with T > 1,
# per-head B and C, and the one-block kernel's shapes
SSD_ROUTE_SHAPES = [(8, 80, 1, 64, 64, 1, True, "step"), (4, 80, 512, 64, 64, 64, True, "split"),
                    (1, 6, 74, 64, 64, 37, True, "split"), (1, 3, 128, 64, 64, 64, False, "split"),
                    (16, 80, 64, 64, 64, 16, True, "split"), (2, 80, 16, 64, 64, 1, True, "step"),
                    (3, 5, 48, 8, 16, 48, False, "split"), (2, 3, 32, 6, 8, 16, False, "block"),
                    (1, 4, 128, 64, 64, 128, True, "block")]


@pytest.mark.parametrize("b,h,t,n,p,chunk,shared,route", SSD_ROUTE_SHAPES)
@pytest.mark.parametrize("strong", [False, True])
def test_ssd_route_matches_plain(cuda, b, h, t, n, p, chunk, shared, route, strong):
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import scan_route

    assert scan_route(chunk, n, p) == route
    hs = h if shared else 1
    args = _ssd_args(cuda, b * h, t, n, p, hs, strong, seed=b * h + t)
    before = dict(ssd.by_route)
    y, s = ssd(*args, chunk, hs)
    assert ssd.by_route == {**before, route: before[route] + 1}
    want = ssd_plain(*args, chunk, hs)
    _close(y, want[0])
    _close(s, want[1])


@pytest.mark.parametrize("kernel", ["wkv", "ssd"])
def test_scan_state_carries_from_the_split_route_to_the_step(cuda, kernel):
    """A 64-token prefill on the split route, then four decode steps on the
    step route, each from the state the last call returned, against one
    plain pass over the 68 tokens."""
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import wkv6, wkv6_plain

    if kernel == "wkv":
        *seq, u, s0 = _wkv_args(cuda, 12, 68, 64, seed=3)
        run = lambda part, s, c: wkv6(*part, u, s, c)  # noqa: E731
        want = wkv6_plain(*seq, u, s0, 4)
    else:
        x, bm, cm, la, s0 = _ssd_args(cuda, 12, 68, 64, 64, 6, seed=3)
        seq = [x, bm, cm, la]
        run = lambda part, s, c: ssd(*part, s, c, 6)  # noqa: E731
        want = ssd_plain(*seq, s0, 4, 6)
    routes = (wkv6 if kernel == "wkv" else ssd).by_route
    before = dict(routes)
    outs, s = [], s0
    for lo, hi, c in ((0, 64, 64), (64, 65, 1), (65, 66, 1), (66, 67, 1), (67, 68, 1)):
        o, s = run([a[:, lo:hi].contiguous() for a in seq], s, c)
        outs.append(o)
    assert routes["split"] == before["split"] + 1 and routes["step"] == before["step"] + 4
    _close(torch.cat(outs, 1), want[0])
    _close(s, want[1])


@pytest.mark.parametrize("kernel", ["wkv", "ssd"])
def test_scan_routes_agree_bitwise_on_the_first_token_from_zero(cuda, kernel):
    """From a zero state the first token's output is the bonus (WKV) or
    (c . b) x (SSD) alone, summed in one order by every new route: a
    decode step, a chunk-1 forward and a chunk-64 forward give the same
    bits there (RWKV6's cold first token amplifies any rounding, PERF.md
    L1)."""
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6

    if kernel == "wkv":
        *seq, u, s0 = _wkv_args(cuda, 32, 64, 64, seed=5)
        run = lambda part, c: wkv6(*part, u, torch.zeros_like(s0), c)[0]  # noqa: E731
    else:
        *seq, s0 = _ssd_args(cuda, 80, 64, 64, 64, 80, seed=5)
        run = lambda part, c: ssd(*part, torch.zeros_like(s0), c, 80)[0]  # noqa: E731
    first = [run(seq, 64)[:, 0], run(seq, 1)[:, 0],
             run([a[:, :1].contiguous() for a in seq], 1)[:, 0]]
    assert torch.equal(first[0], first[1]) and torch.equal(first[0], first[2])


@pytest.mark.parametrize("chunk", [1, 16])
def test_scan_routes_take_operands_off_a_16_byte_boundary(cuda, chunk):
    """Contiguous operands that start one float past a 16-byte boundary
    (views into a larger buffer) reach the step and split routes, which
    load 16 bytes at a time, and give the aligned operands' result."""
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6

    def shifted(a):
        buf = torch.empty(a.numel() + 1, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 and view.is_contiguous()
        return view

    wargs = _wkv_args(cuda, 6, 32, 64, seed=7)
    for got, want in zip(wkv6(*map(shifted, wargs), chunk), wkv6(*wargs, chunk)):
        assert torch.equal(got, want)
    sargs = _ssd_args(cuda, 6, 32, 64, 64, 3, seed=7)
    for got, want in zip(ssd(*map(shifted, sargs), chunk, 3), ssd(*sargs, chunk, 3)):
        assert torch.equal(got, want)


def test_scan_routes_refuse_shapes_they_do_not_take(cuda):
    """The C entry points refuse a route the shape does not fit (the split
    route above chunk 64, the step route at chunk 16), and the wrappers'
    check raises: nothing falls back."""
    from repro_torch.kernels import build

    x, bm, cm, la, s0 = _ssd_args(cuda, 2, 128, 64, 64, 1)
    y, so = torch.empty_like(x), torch.empty_like(s0)
    ws = torch.empty(1 << 20, device=cuda)
    lib = build.load("ssd")
    stream = torch.cuda.current_stream().cuda_stream
    for chunk, route in ((128, 2), (16, 1)):
        code = lib.ssd_launch(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), la.data_ptr(),
                              s0.data_ptr(), y.data_ptr(), so.data_ptr(), ws.data_ptr(), 2, 128,
                              64, 64, chunk, 1, route, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            build.check(lib, code, "ssd")


def test_scan_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import ops

    r = torch.randn(1, 2, 96, 8, device=cuda)
    u, s0 = torch.randn(2, 8, device=cuda), torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv6(r, r, r, -r.abs(), u, s0, chunk=64)
    rb = r.bfloat16()  # bfloat16 scan tensors run; float16 and mixed are refused
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.wkv6(r.half(), r.half(), r.half(), -r.abs().half(), u, s0, chunk=32)
    with pytest.raises(TypeError, match="one storage dtype"):
        ops.wkv6(rb, rb, r, -rb.abs(), u, s0, chunk=32)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(rb, rb, rb, -rb.abs(), u.bfloat16(), s0, chunk=32)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_reduced_model_on_the_card_matches_the_cpu(cuda, arch):
    """forward and decode_step of the reduced model on the card (through
    the kernels) against the same parameters on the CPU (plain versions):
    within 1e-4 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6
    from repro_torch.models import get_family

    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    cpu_params = fam.init(cfg, device="cpu")
    gpu_params = fam.init(cfg, device="cpu").to(cuda)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 32)))
    before = wkv6.launches + ssd.launches
    got, _ = fam.forward(cfg, gpu_params, toks.to(cuda))
    want, _ = fam.forward(cfg, cpu_params, toks)
    _close(got.cpu(), want)
    cache_g = fam.init_cache(cfg, 2, 16)
    cache_c = fam.init_cache(cfg, 2, 16, device="cpu")
    for i in range(4):
        lg, cache_g = fam.decode_step(cfg, gpu_params, cache_g, toks[:, i:i + 1].to(cuda))
        lc, cache_c = fam.decode_step(cfg, cpu_params, cache_c, toks[:, i:i + 1])
        _close(lg.cpu(), lc)
    assert wkv6.launches + ssd.launches >= before + 5 * cfg.n_layers


# ---------------------------------------------------------------------------
# the flash-attention kernel and the dense transformer
# ---------------------------------------------------------------------------


# (b, hq, hk, tq, tk, d, causal, window): the shapes of chip_smoke.py's
# phase 3 at shorter lengths -- Minitron-8B's GQA (32 over 8, D=128),
# starcoder2-15b's (48 over 4) with a window, phi3-mini's D=96,
# stablelm's D=64, the reduced D=16, bidirectional, a ragged Tk (Tq != Tk)
# and a window smaller than one tile
FLASH_SHAPES = [(1, 32, 8, 512, 512, 128, True, None), (1, 48, 4, 1024, 1024, 128, True, 256),
                (1, 32, 32, 256, 256, 96, True, None), (1, 32, 32, 256, 256, 64, True, None),
                (2, 4, 2, 128, 128, 16, True, None), (1, 8, 8, 256, 256, 64, False, None),
                (1, 8, 2, 200, 333, 128, False, None), (1, 8, 2, 256, 256, 128, True, 16)]


@pytest.mark.parametrize("b,hq,hk,tq,tk,d,causal,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, hq, hk, tq, tk, d, causal, window, dtype):
    """Within 1e-4 of the largest plain value in float32; in bfloat16,
    element by element within one bfloat16 step (the module docstring)."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(device=cuda).manual_seed(tq + d)
    q = torch.randn(b, hq, tq, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, hk, tk, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype
    want = flash_attention_ref(q, k, v, causal, window)
    (_close if dtype == torch.float32 else _close_bf16)(got, want)


# (b, hq, hk, tq, tk, d, causal, window): Tk = 0, where no row sees a key;
# a causal Tq = 65, one row spilling into a second tile; D = 8 and D = 24,
# whose q . k depth is zero-padded to a multiple of 16
FLASH_EDGE_SHAPES = [(1, 4, 2, 64, 0, 64, True, None), (1, 4, 2, 65, 65, 128, True, None),
                     (1, 4, 2, 130, 130, 8, True, None), (2, 4, 1, 100, 150, 24, False, None)]


@pytest.mark.parametrize("b,hq,hk,tq,tk,d,causal,window", FLASH_EDGE_SHAPES)
def test_bf16_flash_kernel_at_edge_shapes(cuda, b, hq, hk, tq, tk, d, causal, window):
    """The tensor-core kernel: one launch, and element by element within
    one bfloat16 step of the plain version (the module docstring)."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(device=cuda).manual_seed(tq + d)
    q = torch.randn(b, hq, tq, d, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, hk, tk, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close_bf16(got, flash_attention_ref(q, k, v, causal, window))


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attn import flash_attention

    def qkv(d, hq=4, hk=2, dtype=torch.float32):
        return (torch.randn(1, h, 64, d, device=cuda, dtype=dtype) for h in (hq, hk, hk))

    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*qkv(136))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*qkv(12))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(*qkv(64, dtype=torch.float16))
    with pytest.raises(ValueError, match="multiple of Hk"):
        flash_attention(*qkv(64, hq=6, hk=4))
    q, k, v = qkv(64)
    shifted = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", ["minitron-8b", "starcoder2-15b"])
def test_reduced_transformer_on_the_card_matches_the_cpu(cuda, arch):
    """forward at T=128 (through the flash kernel on the card, its plain
    version on the CPU) and decode steps past starcoder2-reduced's window,
    the same parameters on both: within 1e-4 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models import get_family

    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    cpu_params = fam.init(cfg, device="cpu")
    gpu_params = fam.init(cfg, device="cpu").to(cuda)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 128)))
    before = flash_attention.launches
    got, _ = fam.forward(cfg, gpu_params, toks.to(cuda))
    assert flash_attention.launches == before + cfg.n_layers
    want, _ = fam.forward(cfg, cpu_params, toks)
    _close(got.cpu(), want)
    cache_g = fam.init_cache(cfg, 2, 64)
    cache_c = fam.init_cache(cfg, 2, 64, device="cpu")
    for i in range(40):
        lg, cache_g = fam.decode_step(cfg, gpu_params, cache_g, toks[:, i:i + 1].to(cuda))
        lc, cache_c = fam.decode_step(cfg, cpu_params, cache_c, toks[:, i:i + 1])
        _close(lg.cpu(), lc)


def test_reduced_transformer_at_a_ragged_length_on_the_card(cuda):
    """forward at T=40, not a multiple of the kernel's tiles, still takes
    the flash kernel (one launch a layer) and agrees with the CPU within
    1e-4 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models import get_family

    cfg = get_config("starcoder2-15b", reduced=True)
    fam = get_family(cfg)
    cpu_params = fam.init(cfg, device="cpu")
    gpu_params = fam.init(cfg, device="cpu").to(cuda)
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 40)))
    before = flash_attention.launches
    got, _ = fam.forward(cfg, gpu_params, toks.to(cuda))
    assert flash_attention.launches == before + cfg.n_layers
    want, _ = fam.forward(cfg, cpu_params, toks)
    _close(got.cpu(), want)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b", "phi-3-vision-4.2b"])
def test_reduced_moe_and_vlm_on_the_card_match_the_cpu(cuda, arch):
    """forward at T=64 (phi-3-vision with its patches prepended; through
    the flash kernel on the card, its plain version on the CPU) with the
    routers' aux loss, and 40 decode steps (past mixtral-reduced's window),
    the same parameters on both: within 1e-4 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models import get_family

    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    cpu_params = fam.init(cfg, device="cpu")
    gpu_params = fam.init(cfg, device="cpu").to(cuda)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 64)))
    patches = (torch.randn(2, cfg.n_patches, cfg.d_model, generator=torch.Generator()
                           .manual_seed(1)) if cfg.n_patches else None)
    before = flash_attention.launches
    got, aux_g = fam.forward(cfg, gpu_params, toks.to(cuda),
                             None if patches is None else patches.to(cuda))
    assert flash_attention.launches == before + cfg.n_layers
    want, aux_c = fam.forward(cfg, cpu_params, toks, patches)
    _close(got.cpu(), want)
    assert abs(float(aux_g) - float(aux_c)) <= 1e-4 * max(abs(float(aux_c)), 1e-30)
    cache_g = fam.init_cache(cfg, 2, 64)
    cache_c = fam.init_cache(cfg, 2, 64, device="cpu")
    for i in range(40):
        lg, cache_g = fam.decode_step(cfg, gpu_params, cache_g, toks[:, i:i + 1].to(cuda))
        lc, cache_c = fam.decode_step(cfg, cpu_params, cache_c, toks[:, i:i + 1])
        _close(lg.cpu(), lc)


def test_moe_dispatch_with_drops_on_the_card_matches_the_cpu(cuda):
    """moe_mlp at a capacity that drops slots (groups of 16, capacity
    factor 0.5): the same routing and the same dropped slots on the card
    as on the CPU, outputs within 1e-4 of the largest, the aux loss too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("deepseek-moe-16b", reduced=True), moe_group=16,
                              capacity_factor=0.5)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    on_card = {"router": params["router"].to(cuda),
               **{nm: {k: v.to(cuda) for k, v in params[nm].items()}
                  for nm in ("experts", "shared")}}
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    xg = x.reshape(-1, 16, cfg.d_model)
    idx_c = moe.route(cfg, params["router"], xg)[3]
    idx_g = moe.route(cfg, on_card["router"], xg.to(cuda))[3]
    assert torch.equal(idx_g.cpu(), idx_c)
    dropped = moe.slot_counts(cfg, on_card["router"], x.to(cuda))[0]
    assert int(dropped) == int(moe.slot_counts(cfg, params["router"], x)[0]) > 0
    y_g, aux_g = moe.moe_mlp(cfg, on_card, x.to(cuda))
    y_c, aux_c = moe.moe_mlp(cfg, params, x)
    _close(y_g.cpu(), y_c)
    assert abs(float(aux_g) - float(aux_c)) <= 1e-4 * abs(float(aux_c))


def test_reduced_whisper_on_the_card_matches_the_cpu(cuda):
    """encode (the bidirectional flash kernel, once a layer), decode_train
    (causal self- and cross-attention, twice a layer) and 24 decode steps
    with the cross cache filled by precompute_cross_kv, the same parameters
    on both: within 1e-4 of the largest value."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models import whisper

    cfg = get_config("whisper-medium", reduced=True)
    cpu_params = whisper.init(cfg, device="cpu")
    gpu_params = whisper.init(cfg, device="cpu").to(cuda)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=torch.Generator().manual_seed(3))
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 24)))
    before = flash_attention.launches
    enc_g = whisper.encode(cfg, gpu_params, frames.to(cuda))
    assert flash_attention.launches == before + cfg.n_enc_layers
    enc_c = whisper.encode(cfg, cpu_params, frames)
    _close(enc_g.cpu(), enc_c)
    before = flash_attention.launches
    got = whisper.decode_train(cfg, gpu_params, toks.to(cuda), enc_g)
    assert flash_attention.launches == before + 2 * cfg.n_layers
    _close(got.cpu(), whisper.decode_train(cfg, cpu_params, toks, enc_c))
    cache_g = whisper.init_cache(cfg, 2, 24)
    cache_c = whisper.init_cache(cfg, 2, 24, device="cpu")
    for cache, params, enc in ((cache_g, gpu_params, enc_g), (cache_c, cpu_params, enc_c)):
        cache["cross_k"], cache["cross_v"] = whisper.precompute_cross_kv(cfg, params, enc)
    for i in range(24):
        lg, cache_g = whisper.decode_step(cfg, gpu_params, cache_g, toks[:, i:i + 1].to(cuda))
        lc, cache_c = whisper.decode_step(cfg, cpu_params, cache_c, toks[:, i:i + 1])
        _close(lg.cpu(), lc)


# ---------------------------------------------------------------------------
# fleets: S systems folded into each kernel's chain axis
# ---------------------------------------------------------------------------

# the K' of pow2 buckets at the serving sizes: bts copies by cp.async at
# K' = 2 (K % 4 != 0) and by TMA from 4 on; BCR's blocks are 2K' = 4 .. 32
FLEET_K = [2, 4, 8, 16]


def _fleet(cuda, s, n, k, p, d=1.0):
    bands = np.stack([random_banded(n, k, d, seed=i).astype(np.float32) for i in range(s)])
    return band_to_block_tridiag(torch.tensor(bands, device=cuda), k, p)


def _launches():
    from repro_torch.kernels import bcr

    return {"btf": btf.launches, "bts": bts.launches, "fused": fused_factor_spike.launches,
            "inv_odd": bcr.inv_odd.launches, "reduce": bcr.reduce.launches,
            "rhs_reduce": bcr.rhs_reduce.launches, "backsub": bcr.backsub.launches}


def _launched(before):
    return {nm: c - before[nm] for nm, c in _launches().items() if c != before[nm]}


@pytest.mark.parametrize("k", FLEET_K)
@pytest.mark.parametrize("r", [1, 4])
def test_fleet_fold_matches_per_system_launches(cuda, k, r):
    """btf, bts and the fused pass over S*P chains in one launch each agree
    with one launch per system and with the plain versions."""
    s, p = 8, 16
    bt = _fleet(cuda, s, 4096, k, p)
    rhs = torch.randn(bt.d.shape[:4] + (r,), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(k))
    before = _launches()
    lu = ops.block_tridiag_factor(bt.d, bt.e, bt.f)
    x = ops.block_tridiag_solve(lu, rhs)
    fs = ops.fused_factor_spike(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    assert _launched(before) == {"btf": 1, "bts": 1, "fused": 1}
    ref = bl.btf_ref(bt.d.flatten(0, 1), bt.e.flatten(0, 1), bt.f.flatten(0, 1))
    _close(lu.sinv.flatten(0, 1), ref.sinv)
    _close(x.flatten(0, 1), bl.bts_ref(ref, rhs.flatten(0, 1)))
    for i in range(s):
        one = ops.block_tridiag_factor(bt.d[i], bt.e[i], bt.f[i])
        _close(lu.sinv[i], one.sinv)
        _close(lu.l[i], one.l)
        _close(x[i], ops.block_tridiag_solve(one, rhs[i]))
        ones = ops.fused_factor_spike(bt.d[i], bt.e[i], bt.f[i], bt.b_cpl[i], bt.c_cpl[i])
        for got, want in ((fs.lu.sinv[i], ones.lu.sinv), (fs.lu.l[i], ones.lu.l),
                          (fs.v_bot[i], ones.v_bot), (fs.v_top[i], ones.v_top),
                          (fs.w_top[i], ones.w_top), (fs.w_bot[i], ones.w_bot)):
            _close(got, want)


def _chain_residual(d, e, f, y, h):
    """||h - A y|| / ||h|| in float64 for the chain A of blocks (d, e, f),
    e[0] and f[m-1] left out as BCR leaves them."""
    d, e, f, y, h = (t.double() for t in (d, e, f, y, h))
    ay = d @ y
    ay[1:] += e[1:] @ y[:-1]
    ay[:-1] += f[:-1] @ y[1:]
    return float((h - ay).norm() / h.norm())


@pytest.mark.parametrize("k", FLEET_K)
def test_stacked_bcr_matches_per_chain_bcr(cuda, k):
    """S reduced chains of 15 interfaces (P = 16) through one launch of each
    BCR kernel a level agree with BCR of each chain alone on the kernels
    (roots, odd-block inverses, solves within 1e-4), and each solve leaves
    a float64 residual at most 10x the plain version's on its chain.
    Partitions of two block rows keep the chains' couplings E, F active;
    such chains are ill-conditioned enough (float32 residuals 1e-5 to
    3e-5) that the kernels' and the plain version's whole factors, each
    rounded level by level, part by ~2e-4 of the root at K = 2, so the
    plain version is held per level (test_bcr_kernels_match_plain) and
    here through the residual."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.core.spike import _reduced_interface_system

    s = 16
    bt = _fleet(cuda, s, 16 * 2 * k, k, 16, d=0.5)
    fs = ops.fused_factor_spike(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    rd, re, rf = _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
    assert tuple(rd.shape) == (s, 15, 2 * k, 2 * k)
    h = torch.randn(s, 15, 2 * k, 2, device=cuda)
    before = _launches()
    fac = ops.bcr_factor(rd, re, rf)
    y = ops.bcr_solve(fac, h)
    assert _launched(before) == {"inv_odd": 5, "reduce": 4, "rhs_reduce": 4, "backsub": 4}
    for i in range(s):
        one = ops.bcr_factor(rd[i], re[i], rf[i])
        _close(fac.root_inv[i], one.root_inv)
        for lb, lo in zip(fac.levels, one.levels):
            _close(lb.a_odd[i], lo.a_odd)
        _close(y[i], ops.bcr_solve(one, h[i]))
        plain = cr.bcr_solve(cr.bcr_factor(rd[i], re[i], rf[i]), h[i])
        assert _chain_residual(rd[i], re[i], rf[i], y[i], h[i]) <= 10 * _chain_residual(
            rd[i], re[i], rf[i], plain, h[i])


def test_folded_grid_beyond_its_axis_limit_is_refused(cuda):
    """A level of 65,536 block rows would put 65,536 blocks on reduce's z
    axis and on the tiled solve kernels' y axis: refused, not launched."""
    from repro_torch.kernels import bcr

    m, k = 2 * 65_536, 2
    eye = torch.eye(k, device=cuda).expand(m, k, k).contiguous()
    zero = torch.zeros_like(eye)
    before = _launches()
    with pytest.raises(ValueError, match="z axis exceed its limit of 65,535"):
        bcr.reduce(eye, zero, zero, eye[: m // 2].contiguous())
    b = torch.zeros(m, k, 9, device=cuda)  # R > 8: the tiled kernels
    with pytest.raises(ValueError, match="y axis"):
        bcr.rhs_reduce(zero[: m // 2].contiguous(), zero[: m // 2].contiguous(), b)
    with pytest.raises(ValueError, match="y axis"):
        bcr.backsub(eye[: m // 2].contiguous(), zero[: m // 2].contiguous(),
                    zero[: m // 2].contiguous(), b, b[: m // 2].contiguous())
    assert _launched(before) == {}


FLEET_CASES = [("C", "auto", 1.0), ("D", "auto", 1.0), ("E", "chain", 0.5), ("E", "bcr", 0.5)]


@pytest.mark.parametrize("variant,reduced,d", FLEET_CASES)
def test_batch_launches_each_kernel_as_one_system_does(cuda, variant, reduced, d):
    """A batch factor launches every kernel as often as one system's factor,
    an apply as often as one system's apply; each system's solution and
    sweep count are its single solve's (x within 1e-5)."""
    import math

    from repro_torch.core import batch_factor, batch_plan

    s, n = 6, 2048
    bands = [random_banded(n, 8, d, seed=i).astype(np.float32) for i in range(s)]
    rng = np.random.default_rng(0)
    bs = np.stack([rng.normal(size=n) for _ in range(s)])
    opts = SaPOptions(p=16, variant=variant, reduced_solver=reduced, tol=1e-8, maxiter=100)
    before = _launches()
    bfac = batch_factor(batch_plan(bands, opts))
    batch_factor_launches = _launched(before)
    before = _launches()
    res = bfac.solve_batch(torch.tensor(bs, device=cuda))
    batch_solve = _launched(before)
    for i in range(s):
        before = _launches()
        fac = factor(plan_banded(bands[i], opts))
        assert _launched(before) == batch_factor_launches
        before = _launches()
        one = fac.solve(bs[i])
        single_solve = _launched(before)
        assert math.ceil(float(one.iterations)) == math.ceil(float(res.iterations[i]))
        assert float(res.true_resnorm[i]) <= 1e-6
        x = one.x.double()
        assert float((res.x[i].double() - x).norm() / x.norm()) <= 1e-5
    # launches per preconditioner apply: 2 + 4 a sweep of BiCGStab(2)
    applies_one = 2 + 4 * math.ceil(float(one.iterations))
    applies_batch = 2 + 4 * math.ceil(float(res.iterations.max()))
    assert {nm: c / applies_batch for nm, c in batch_solve.items()} == {
        nm: c / applies_one for nm, c in single_solve.items()}


@pytest.mark.parametrize("variant", ["C", "D", "E"])
def test_k_rounding_bucket_on_the_card(cuda, variant):
    """The misconvergence guard cases through the card kernels: a K=3 fleet
    bucketed to K'=4 (interleaved) solves as each unpadded system does,
    and the oscillatory d = 0.5 band converges truly under E."""
    from repro_torch.core import batch_factor, batch_plan, oscillatory_banded, pad_rhs_to
    from repro_torch.core import unpad_solution

    opts = SaPOptions(p=4, variant=variant, tol=1e-6, maxiter=400)
    bands = [random_banded(96, 3, 1.2, seed=s).astype(np.float32) for s in range(3)]
    rng = np.random.default_rng(11)
    bs = [np.float32(rng.normal(size=96)) for _ in bands]
    bpl = batch_plan(bands, opts)
    assert bpl.k == 4
    res = batch_factor(bpl).solve_batch(torch.stack([pad_rhs_to(b, bpl.n) for b in bs]))
    assert bool(res.converged.all()) and float(res.true_resnorm.max()) <= 1e-4
    for band, b, x in zip(bands, bs, unpad_solution(res.x, bpl.orig_ns)):
        solo = factor(plan_banded(band, opts, device="cpu")).solve(b)
        np.testing.assert_allclose(x, solo.x.numpy(), rtol=1e-3, atol=1e-4)
    if variant == "E":
        osc = oscillatory_banded(128, 3, d=0.5, seed=0).astype(np.float32)
        b = np.float32(np.random.default_rng(1).normal(size=128))
        epl = batch_plan([osc], SaPOptions(p=4, variant="E", tol=1e-5, maxiter=400))
        out = batch_factor(epl).solve_batch(pad_rhs_to(b, epl.n)[None])
        assert bool(out.converged[0]) and float(out.true_resnorm[0]) <= 1e-5


def test_engine_stream_on_the_card_matches_the_cpu(cuda):
    """The same request stream through a SolverEngine on the card and one
    on the CPU: the same buckets, cache hits, evictions, escalations and
    counters; x within 1e-5; every true_resnorm at most 1e-6."""
    from repro_torch.serve import SolverEngine

    opts = SaPOptions(p=4, variant="auto", tol=1e-8, maxiter=200)
    engines = {dev: SolverEngine(opts, max_batch=4, cache_size=3, device=dev)
               for dev in ("cuda", "cpu")}
    mats = [random_banded(300 + 150 * (i % 2), 3 + i % 3, 1.1, seed=i).astype(np.float32)
            for i in range(5)]
    rng = np.random.default_rng(3)
    stream = [(mats[i % 5], rng.normal(size=mats[i % 5].shape[0])) for i in range(14)]
    done = {}
    for dev, eng in engines.items():
        for band, b in stream:
            eng.submit_system(band, b)
        done[dev] = sorted(eng.run_until_drained(), key=lambda r: r.rid)
    for g, c in zip(done["cuda"], done["cpu"]):
        gr, cr_ = g.result, c.result
        assert (gr.bucket, gr.variant, gr.cache_hit, gr.escalated) == (
            cr_.bucket, cr_.variant, cr_.cache_hit, cr_.escalated)
        assert gr.converged and gr.true_resnorm <= 1e-6
        assert np.linalg.norm(gr.x - cr_.x) <= 1e-5 * np.linalg.norm(cr_.x)
    gs, cs = engines["cuda"].stats_snapshot(), engines["cpu"].stats_snapshot()
    for key in ("solved", "steps", "cache_hits", "cache_misses", "factored_systems", "evictions",
                "misconverged", "escalations"):
        assert gs[key] == cs[key], key
    assert gs["evictions"] > 0 and gs["peak_device_bytes"] > 0 and cs["peak_device_bytes"] == 0


def test_engine_guard_escalates_on_the_card(cuda):
    """A K=3 oscillatory matrix stored in K=4 band storage misconverges on
    its first pass; the engine escalates it to an exact bucket on the card."""
    from repro_torch.core import band_to_dense, oscillatory_banded
    from repro_torch.serve import SolverEngine

    n = 128
    band3 = oscillatory_banded(n, 3, d=0.5, seed=1).astype(np.float32)
    wide = np.zeros((n, 9), np.float32)
    wide[:, 1:8] = band3
    dense = band_to_dense(torch.tensor(band3, dtype=torch.float64)).numpy()
    b = np.float32(dense @ np.random.default_rng(11).normal(size=n))
    eng = SolverEngine(SaPOptions(p=4, variant="E", tol=1e-5, maxiter=400))
    eng.submit_system(wide, b)
    (out,) = eng.step()
    assert out.result.escalated and out.result.converged
    assert np.linalg.norm(b - dense @ out.result.x) / np.linalg.norm(b) <= 1e-4
    assert eng.stats["escalations"] == 1


def test_service_drain_thread_on_the_card(cuda):
    """Client threads submit to a service whose drain thread launches the
    kernels on the card; every future resolves with a host array."""
    import threading

    from repro_torch.core import band_to_dense
    from repro_torch.serve import AsyncSolverService

    svc = AsyncSolverService(SaPOptions(p=4, variant="auto", tol=1e-6, maxiter=200), max_batch=4)
    futs = []
    lock = threading.Lock()

    def client(tid):
        for j in range(4):
            band = random_banded(200 + 50 * j, 3 + j % 2, 0.5 + tid % 2, seed=tid * 4 + j)
            band = band.astype(np.float32)
            x = np.random.default_rng(j).normal(size=band.shape[0])
            b = band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy() @ x
            with lock:
                futs.append(svc.submit(band, b, priority=j))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for fut in futs:
        out = fut.result(timeout=120)
        assert isinstance(out.x, np.ndarray) and out.converged
        assert out.true_resnorm <= 1e-5  # 10 tol, the engine's guard
    svc.close()
    assert svc.snapshot()["counters"]["solved"] == 12


# -- observability: spans, calibration and cost accounting on the card --------


def test_span_waits_for_the_card(cuda):
    """A span around a bts launch whose result it syncs lasts at least the
    launch's CUDA-event time: the span's exit waited for the card."""
    from repro_torch.obs import Tracer

    bt = _split(cuda, 12800, 200, 4)
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    rhs = torch.randn(bt.d.shape[:3] + (4,), device=cuda)
    bts(ref.sinv, ref.l, bt.f, rhs)  # warm
    torch.cuda.synchronize()
    tr = Tracer()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # the launch queues behind ~10 ms of spinning
    with tr.span("bts") as sp:
        start.record()
        x = bts(ref.sinv, ref.l, bt.f, rhs)
        stop.record()
        sp.sync({"x": [x]})
    assert stop.query()  # the span's exit waited for the launch
    assert tr.roots()[0].duration_s >= start.elapsed_time(stop) / 1e3


def _sync_reports(fn):
    """fn()'s result and the synchronizing operations the card's sync debug
    mode reports while it runs, each as its warning's text."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice that it is a prototype is not a report
    return out, [str(w.message) for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.parametrize("d,opts", [
    (1.0, dict(variant="C")),
    (0.6, dict(variant="E", reduced_solver="bcr")),
    (0.6, dict(variant="auto", reduced_solver="chain", fused_factor="off")),
])
def test_host_syncs_counter_equals_the_sync_debug_reports(cuda, d, opts):
    """For one plan, factor and solve, the ``host_syncs`` counter adds as
    many as the synchronizing operations that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, and the solve alone
    one a sweep and one more."""
    import math

    from repro_torch.obs import counters

    band = torch.tensor(random_banded(12800, 20, d, seed=5).astype(np.float32), device=cuda)
    b = torch.randn(12800, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
    sopts = SaPOptions(p=8, tol=1e-8, maxiter=200, **opts)
    factor(plan_banded(band, sopts)).solve(b)  # warm
    before = counters()
    fac, factor_syncs = _sync_reports(lambda: factor(plan_banded(band, sopts)))
    mid = counters()
    res, solve_syncs = _sync_reports(lambda: fac.solve(b))
    after = counters()
    assert mid["host_syncs"] - before["host_syncs"] == len(factor_syncs), factor_syncs
    assert after["host_syncs"] - mid["host_syncs"] == len(solve_syncs), solve_syncs
    assert len(solve_syncs) == math.ceil(float(res.iterations)) + 1
    assert after["solves"] - mid["solves"] == 1


def test_factor_stage_spans_time_the_card_without_waiting(cuda, monkeypatch):
    """The factor's stage spans carry the card's time of their work
    (``device_s``, from a CUDA-event pair) and wait for nothing: only the
    ``factor`` span's close waits, so their device times sum to at most
    the ``factor`` span."""
    from repro_torch.obs import Tracer, use_tracer
    from repro_torch.obs import trace as trace_mod

    band = torch.tensor(random_banded(12800, 200, 0.6, seed=3).astype(np.float32), device=cuda)
    opts = SaPOptions(p=8, variant="E", reduced_solver="bcr", tol=1e-8, maxiter=200)
    factor(plan_banded(band, opts))  # warm
    waited = []
    real = trace_mod._wait_for_card

    def wait(value):
        waited.append(tr._stack()[-1].name)
        real(value)

    tr = Tracer()
    monkeypatch.setattr(trace_mod, "_wait_for_card", wait)
    with use_tracer(tr):
        factor(plan_banded(band, opts))
    assert waited == ["factor"]
    (fac_sp,) = tr.find("factor")
    stages = fac_sp.children
    assert [c.name for c in stages] == ["factor.split", "factor.fused", "factor.reduced"]
    assert all(c.device_s is not None and c.device_s > 0 for c in stages)
    assert sum(c.device_s for c in stages) <= fac_sp.duration_s + 1e-4
    assert fac_sp.attrs["launches"]["fused_factor_spike"] == 1
    assert "device" in tr.summary().splitlines()[0]


def test_calibrated_ceilings_on_the_card(cuda):
    """The measured ceilings are positive and at most 1.05x the data sheet's
    (67 TFLOP/s float32, 989 TFLOP/s bfloat16, 3.35 TB/s): more would be a
    timing fault."""
    from repro_torch.launch import calibrate

    spec = calibrate.calibrate(gemm_n=4096, stream_bytes=1 << 29, repeats=5)
    assert spec.name == "cuda-calibrated"
    for rate, sheet in ((spec.peak_flops, 67e12), (spec.peak_bf16_flops, 989e12),
                        (spec.hbm_bw, 3.35e12)):
        assert 0.0 < rate <= 1.05 * sheet
    assert torch.backends.cuda.matmul.allow_tf32 is False  # restored as the fixture set it


def test_engine_cost_accounting_on_the_card(cuda):
    """Every achieved fraction -- the engine's accumulated roofline seconds
    of a stage over its measured seconds -- is at most 1.05."""
    from repro_torch.serve import SolverEngine

    opts = SaPOptions(p=8, variant="C", tol=1e-6, maxiter=200)
    eng = SolverEngine(opts, max_batch=16, cost_accounting=True)
    bands = [random_banded(4096, 16, 1.1, seed=s).astype(np.float32) for s in range(16)]
    for rnd in range(2):  # a miss step, then a hit step
        for s, band in enumerate(bands):
            eng.submit_system(band, np.random.default_rng(rnd * 16 + s).normal(size=4096))
        eng.step()
    assert eng.stats["cache_hits"] == 16 and eng.stats["factored_systems"] == 16
    totals, stats = eng.cost_snapshot(), eng.stats_snapshot()
    fractions = {"factor": totals["factor"]["roofline_s"] / stats["factor_seconds_total"],
                 "krylov": totals["krylov"]["roofline_s"] / stats["solve_seconds_total"]}
    assert all(0.0 < f <= 1.05 for f in fractions.values()), fractions
    assert stats["peak_device_bytes"] > 0


def test_float32_stall_at_tol_1e8_on_the_card(cuda):
    """The CPU parity case of ``test_torch_solver_engine.py`` on the card:
    the request escalates, and its true residual lies within 10x of the
    CPU port's (both at the float32 preconditioner's stall)."""
    from repro_torch.core import band_to_dense
    from repro_torch.serve import SolverEngine

    band = random_banded(200, 3, 0.5, seed=8).astype(np.float32)
    x = np.random.default_rng(0).normal(size=200)
    b = band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy() @ x
    opts = SaPOptions(p=4, variant="auto", tol=1e-8, maxiter=200)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = SolverEngine(opts, max_batch=1, device=dev)
        eng.submit_system(band, b)
        (done,) = eng.run_until_drained()
        out[dev] = done.result
    g, c = out["cuda"], out["cpu"]
    assert g.escalated and (g.bucket, g.variant) == (c.bucket, c.variant) == ((204, 3, 4), "E")
    assert max(g.true_resnorm, c.true_resnorm) <= 10 * min(g.true_resnorm, c.true_resnorm)


def test_service_request_spans_from_a_drain_thread_on_the_card(cuda):
    """A service whose drain thread launches on the card: one serve.request
    span per request, and every dispatch wraps the engine's span."""
    import threading

    from repro_torch.obs import Tracer, use_tracer
    from repro_torch.serve import AsyncSolverService

    tr = Tracer()
    with use_tracer(tr):
        svc = AsyncSolverService(SaPOptions(p=4, variant="auto", tol=1e-6, maxiter=200),
                                 max_batch=4)
        futs = []
        for j in range(6):
            band = random_banded(300 + 20 * j, 4, 1.1 if j % 2 else 0.5, seed=j)
            band = band.astype(np.float32)
            futs.append(svc.submit(band, np.random.default_rng(j).normal(size=band.shape[0])))
        outs = [f.result(timeout=120) for f in futs]
        svc.close()
    assert all(o.converged for o in outs)
    reqs = tr.find("serve.request")
    assert sorted(sp.attrs["rid"] for sp in reqs) == [f.rid for f in futs]
    dispatches = tr.find("serve.dispatch")
    assert dispatches and sum(d.attrs["batch"] for d in dispatches) == 6
    main = threading.get_ident()
    for d in dispatches:  # on the drain thread
        assert [c.name for c in d.children] == ["engine.solve_prepared"] and d.tid != main


# ---------------------------------------------------------------------------
# Training: gradients through the kernels' autograd Functions
# ---------------------------------------------------------------------------


def _card_and_plain_grads(out_of, inputs, w):
    """The output of ``out_of(*inputs)`` and the gradients of its sum
    weighted by ``w``, twice: through ``ops`` (the Functions, whose forward
    is the kernel) and through the plain versions (``out_of(...,
    plain=True)``).  Returns ((output, gradients), (output, gradients))."""
    res = []
    for plain in (False, True):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = out_of(*xs, plain=plain)
        (out.float() * w.float()).sum().backward()
        res.append((out.detach(), [x.grad for x in xs]))
    return res


# (B, Hq, Hk, T, D, causal, window, dtype): stablelm-1.6b's training shape
# in both dtypes, then GQA, windowed and bidirectional cases
FLASH_GRAD_CASES = [
    (8, 32, 32, 256, 64, True, None, torch.bfloat16),
    (8, 32, 32, 256, 64, True, None, torch.float32),
    (2, 8, 2, 200, 32, True, None, torch.bfloat16),
    (2, 4, 4, 192, 16, True, 48, torch.float32),
    (2, 4, 2, 150, 64, False, None, torch.bfloat16),
]


@pytest.mark.parametrize("b,hq,hk,t,d,causal,window,dtype", FLASH_GRAD_CASES)
def test_flash_function_on_the_card_gives_the_plain_gradient(cuda, b, hq, hk, t, d, causal,
                                                            window, dtype):
    """ops.flash_attention on operands that require grad: the forward is
    the kernel (one launch), its output within the kernel's limits of the
    plain version's (one bfloat16 step, or 1e-4 of the largest value in
    float32), the backward autograd of the plain version (one recompute),
    the gradients equal to autograd of the plain version on the same card
    and in the inputs' dtype; GQA's K, V gradients summed over each query
    group."""
    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(cuda).manual_seed(t)
    q = torch.randn(b, hq, t, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, hk, t, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    w = torch.randn(b, hq, t, d, generator=g, device=cuda).to(dtype)

    def out_of(q, k, v, plain):
        fn = flash_attention_ref if plain else ops.flash_attention
        return fn(q, k, v, causal=causal, window=window)

    launches, recomputes = flash_attention.launches, kgrad.backward_calls["flash"]
    (o, (gq, gk, gv)), (o_plain, plain) = _card_and_plain_grads(out_of, (q, k, v), w)
    assert flash_attention.launches == launches + 1
    assert kgrad.backward_calls["flash"] == recomputes + 1
    (_close_bf16 if dtype == torch.bfloat16 else _close)(o, o_plain)
    for got, want in zip((gq, gk, gv), plain):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wkv6_function_on_the_card_gives_the_plain_gradient(cuda):
    """RWKV6-1.6B's heads (32 x 64) at chunk 64 on the split route: the
    Function's output (the kernel's) within 1e-4 of the largest plain
    value, u's gradient summed over the batch, the final state's gradient
    absent."""
    from repro_torch.kernels.ref import wkv6_chunked_ref
    from repro_torch.kernels.wkv import wkv6

    b, h, t, d = 2, 32, 256, 64
    g = torch.Generator(cuda).manual_seed(0)
    r, k, v = (torch.randn(b, h, t, d, generator=g, device=cuda) * 0.5 for _ in range(3))
    logw = -torch.exp(torch.randn(b, h, t, d, generator=g, device=cuda) * 0.5 - 2.0)
    u = torch.randn(h, d, generator=g, device=cuda) * 0.1
    s0 = torch.zeros(b, h, d, d, device=cuda)
    w = torch.randn(b, h, t, d, generator=g, device=cuda)

    def out_of(r, k, v, logw, u, plain):
        if plain:
            return wkv6_chunked_ref(r, k, v, logw, u, s0, 64)[0]
        return ops.wkv6(r, k, v, logw, u, s0, chunk=64)[0]

    before = dict(wkv6.by_route)
    (o, got), (o_plain, want) = _card_and_plain_grads(out_of, (r, k, v, logw, u), w)
    assert wkv6.by_route["split"] == before["split"] + 1
    _close(o, o_plain)
    assert got[4].shape == (h, d)
    for x, y in zip(got, want):
        _close(x, y)


def test_ssd_function_on_the_card_sums_shared_b_and_c_over_the_heads(cuda):
    """Zamba2-2.7B's scan (80 heads of 64, N = 64) at chunk 64 with B and C
    shared by the heads (handed to the kernel once a row): the Function's
    output (the kernel's) within 1e-4 of the largest plain value, B's and
    C's gradients summed over the heads."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd import ssd

    b, h, t, n, p = 2, 80, 256, 64, 64
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(b, h, t, p, generator=g, device=cuda) * 0.1
    bm, cm = (torch.randn(b, t, n, generator=g, device=cuda) * 0.2 for _ in range(2))
    loga = -torch.rand(b, h, t, generator=g, device=cuda) * 0.2
    s0 = torch.zeros(b, h, n, p, device=cuda)
    w = torch.randn(b, h, t, p, generator=g, device=cuda)

    def out_of(x, bm, cm, loga, plain):
        bh, ch = (a[:, None].expand(b, h, t, n) for a in (bm, cm))
        if plain:
            return ssd_chunked_ref(x, bh, ch, loga, s0, 64)[0]
        return ops.ssd(x, bh, ch, loga, s0, chunk=64)[0]

    before = ssd.launches
    (y, got), (y_plain, want) = _card_and_plain_grads(out_of, (x, bm, cm, loga), w)
    assert ssd.launches == before + 1
    _close(y, y_plain)
    assert got[1].shape == (b, t, n)
    for u, v in zip(got, want):
        _close(u, v)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_reduced_loss_and_gradients_on_the_card_match_the_cpu(cuda, arch):
    """Each family's loss and every parameter's gradient on the card
    (through the kernels' Functions) against the CPU port's: the loss
    within 1e-5 relative, each gradient within 1e-4 of its largest value."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_family

    cfg = get_config(arch, reduced=True)
    fam = get_family(cfg)
    cpu = fam.init(cfg, device="cpu").requires_grad_(True)
    gpu = fam.init(cfg, device="cpu").to(cuda).requires_grad_(True)
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 128)))
    lc, _ = fam.loss(cfg, cpu, {"tokens": toks})
    lg, _ = fam.loss(cfg, gpu, {"tokens": toks.to(cuda)})
    lc.backward()
    lg.backward()
    assert abs(float(lg.detach()) - float(lc.detach())) <= 1e-5 * abs(float(lc.detach()))
    mine = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        _close(mine[name].grad.cpu(), p.grad)


def test_train_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Two make_train_step calls (two microbatches) on the card against
    the CPU port's: the losses within 1e-5 relative, the
    parameters within 1e-5 (lr 1e-4: Adam turns the gradients' ~1e-6
    relative difference into at most lr on an element whose gradient is
    near 0)."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.models import get_family
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config("stablelm-1.6b", reduced=True)
    fam = get_family(cfg)
    step = make_train_step(cfg, optim.AdamWConfig(lr=1e-4, warmup_steps=0),
                           TrainConfig(microbatches=2, checkpoint_dir=str(tmp_path)))
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab, size=(4, 64)))
    runs = []
    for dev in ("cpu", cuda):
        model = fam.init(cfg, device="cpu").to(dev).requires_grad_(True)
        params = dict(model.named_parameters())
        state = optim.init(params)
        losses = [float(step(model, state, {}, {"tokens": toks.to(dev)})["loss"])
                  for _ in range(2)]
        runs.append((losses, params))
    (lc, pc), (lg, pg) = runs
    for a, b in zip(lg, lc):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, p in pc.items():
        assert float((pg[name].detach().cpu() - p.detach()).abs().max()) <= 1e-5, name


# ---------------------------------------------------------------------------
# the distributed path on two ranks of the card (one gloo group on cuda:0)
# ---------------------------------------------------------------------------

DIST_N, DIST_K, DIST_P = 4000, 16, 16


def _dist_system():
    from repro_torch.core import band_matvec

    band = random_banded(DIST_N, DIST_K, 0.5, seed=1).astype(np.float32)
    xstar = np.random.default_rng(0).normal(size=DIST_N)
    b = band_matvec(torch.tensor(band, dtype=torch.float64), torch.tensor(xstar)).numpy()
    return band, xstar, b


def _dist_solver_body():
    """D, C and E on this rank (two ranks, P = 16 in all): the whole x, the
    sweeps and this rank's kernel launches of each."""
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.kernels import bcr
    from repro_torch.launch.mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh((2,), ("data",))
    band, _, b = _dist_system()
    wrappers = {"btf": btf, "bts": bts, "fused": fused_factor_spike, "inv_odd": bcr.inv_odd}
    out = {}
    for variant in ("D", "C", "E"):
        before = {nm: w.launches for nm, w in wrappers.items()}
        dsap = D.build_dist_sap(mesh, DIST_N, DIST_K, variant, p_per_device=DIST_P // 2)
        band_l, b_l, parts = dsap.shard_band(band, b)
        res = D.solve_step_fn(dsap, 1e-6, 200)(band_l, b_l, *parts.values())
        out[variant] = {"x": D.gather_x(res.x, mesh, DIST_N).cpu(),
                        "iterations": float(res.iterations),
                        "launches": {nm: w.launches - before[nm] for nm, w in wrappers.items()}}
    return out if dist.get_rank() == 0 else None


def test_distributed_solver_on_two_ranks_of_the_card(cuda):
    """The solver split over two ranks of the card against the
    single-process solve at the same P: x within 1e-5 relative (float32
    preconditioners, float64 iterations; dots summed in another order and,
    for E, the chain reduced by PCR instead of BCR), sweeps within 1; each
    rank launches the kernels of its variant."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks

    build.build_all()
    got = spawn_ranks(_dist_solver_body, 2, timeout=300)[0]
    band, _, b = _dist_system()
    must = {"D": ("btf", "bts"), "C": ("fused", "bts"), "E": ("fused", "bts", "inv_odd")}
    for variant, run in got.items():
        opts = SaPOptions(p=DIST_P, variant=variant, tol=1e-6, maxiter=200)
        ref = factor(plan_banded(band, opts)).solve(torch.tensor(b, device=cuda))
        x, want = run["x"].to(cuda), ref.x
        assert float((x - want).norm() / want.norm()) <= 1e-5, variant
        assert abs(run["iterations"] - float(ref.iterations)) <= 1.0, variant
        for nm in must[variant]:
            assert run["launches"][nm] > 0, (variant, nm, run["launches"])


def _scan_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    ssd_in = (rn(1, 4, 512, 64), rn(1, 4, 512, 64), rn(1, 4, 512, 64),
              -torch.exp(0.5 * rn(1, 4, 512)))
    wkv_in = (rn(1, 4, 512, 64), rn(1, 4, 512, 64), rn(1, 4, 512, 64),
              -torch.exp(0.5 * rn(1, 4, 512, 64)), rn(4, 64))
    return ssd_in, wkv_in


def _dist_scan_body():
    """This rank's half of T through sp_ssd / sp_wkv6 (chunk 64), with the
    routes its launches took."""
    import torch.distributed as dist

    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sequence_parallel import sp_ssd, sp_wkv6

    mesh = make_test_mesh((2,), ("data",))
    ssd_in, wkv_in = _scan_inputs(mesh.device)
    sl = slice(256 * mesh.rank, 256 * (mesh.rank + 1))
    out = {}
    for name, fn, args, w in (("ssd", sp_ssd(mesh), ssd_in, ssd),
                              ("wkv", sp_wkv6(mesh), wkv_in[:4], wkv6)):
        w.by_route.update(dict.fromkeys(w.by_route, 0))
        extra = (wkv_in[4],) if name == "wkv" else ()
        y, s = fn(*(a[:, :, sl] for a in args), *extra)
        out[name] = {"y": y.cpu(), "s": s[0].cpu(), "routes": dict(w.by_route)}
    gathered = [None, None]
    dist.all_gather_object(gathered, out)
    return gathered if dist.get_rank() == 0 else None


def test_sequence_parallel_scans_on_two_ranks_of_the_card(cuda):
    """sp_ssd / sp_wkv6 over two ranks of the card against the single-rank
    kernel call at the full T: within 1e-4 of the largest value (the carry
    is exact; the fold-in sums in float32 in another order); every shard
    takes the split route."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks

    build.build_all()
    shards = spawn_ranks(_dist_scan_body, 2, timeout=300)[0]
    ssd_in, wkv_in = _scan_inputs(cuda)
    want = {"ssd": ops.ssd(*ssd_in, torch.zeros(1, 4, 64, 64, device=cuda)),
            "wkv": ops.wkv6(*wkv_in, torch.zeros(1, 4, 64, 64, device=cuda))}
    for name, (y_ref, s_ref) in want.items():
        y = torch.cat([sh[name]["y"] for sh in shards], dim=2).to(cuda)
        _close(y, y_ref)
        _close(shards[1][name]["s"].to(cuda), s_ref)
        for sh in shards:
            assert sh[name]["routes"] == {"block": 0, "step": 0, "split": 1}, sh[name]["routes"]


# ---------------------------------------------------------------------------
# the sharded LM loss on two ranks of the card (one gloo group on cuda:0)
# ---------------------------------------------------------------------------

SHARDED_B, SHARDED_T = 4, 64


def _sharded_cfg(name):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name, reduced=True), compute_dtype="float32")


def _sharded_inputs(cfg, dev):
    from repro_torch.models import get_family

    model = get_family(cfg).init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (SHARDED_B, SHARDED_T),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    return model, tokens


def _sharded_body(names):
    """The sharded loss and gradient of each reduced config on a (1, 2)
    ("data", "model") mesh of this process's rank: the loss, the gathered
    gradients and this rank's flash launches."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh((1, 2), ("data", "model"))
    out = {}
    for name in names:
        cfg = _sharded_cfg(name)
        model, tokens = _sharded_inputs(cfg, mesh.device)
        local = sharded.shard_model(cfg, model, mesh)
        before = flash_attention.launches
        loss, grads = sharded.value_and_grad(cfg, local, {"tokens": tokens}, mesh)
        out[name] = {"loss": float(loss), "flash": flash_attention.launches - before,
                     "grads": {n: g.cpu() for n, g in sharded.gather_tree(cfg, grads, mesh).items()}}
    return out if dist.get_rank() == 0 else None


def test_sharded_dense_loss_on_two_ranks_of_the_card(cuda):
    """The dense loss split over "model" on two ranks of the card (MHA and
    GQA, float32 compute) against the single process on the card: the loss
    within 1e-5 relative, each gathered gradient within 1e-4 of its
    largest magnitude (the CPU tests' limits); each rank's attention ran
    on the flash kernel, one launch a layer."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import get_family

    names = ("stablelm-1.6b", "minitron-8b")
    build.build_all()
    got = spawn_ranks(_sharded_body, 2, args=(names,), timeout=300)[0]
    for name in names:
        cfg = _sharded_cfg(name)
        model, tokens = _sharded_inputs(cfg, cuda)
        model.requires_grad_(True)
        loss, _ = get_family(cfg).loss(cfg, model, {"tokens": tokens})
        loss.backward()
        assert abs(got[name]["loss"] - float(loss)) <= 1e-5 * abs(float(loss)), name
        assert got[name]["flash"] == cfg.n_layers, name
        for n, p in model.named_parameters():
            want = p.grad.detach()
            err = float((got[name]["grads"][n].to(cuda) - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, n, err)


def test_sharded_moe_loss_on_two_ranks_of_the_card(cuda):
    """The MoE loss split over "model" on two ranks of the card (deepseek-
    moe's experts and its shared experts, mixtral's four experts; float32
    compute): the same limits against the single process on the card as
    the dense loss, the routers' gradients included; the flash kernel once
    a layer."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import get_family

    names = ("deepseek-moe-16b", "mixtral-8x22b")
    build.build_all()
    got = spawn_ranks(_sharded_body, 2, args=(names,), timeout=300)[0]
    for name in names:
        cfg = _sharded_cfg(name)
        model, tokens = _sharded_inputs(cfg, cuda)
        model.requires_grad_(True)
        loss, _ = get_family(cfg).loss(cfg, model, {"tokens": tokens})
        loss.backward()
        assert abs(got[name]["loss"] - float(loss)) <= 1e-5 * abs(float(loss)), name
        assert got[name]["flash"] == cfg.n_layers, name
        for n, p in model.named_parameters():
            want = p.grad.detach()
            err = float((got[name]["grads"][n].to(cuda) - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, n, err)


def test_model_kernels_at_the_ranks_local_head_shapes(cuda):
    """flash, WKV6 and SSD at the shapes the sharded loss gives one rank of
    a (2, 2) mesh at the published widths (half the heads, half the batch
    of B=8, T=256): stablelm-1.6b's 16 of 32 heads in bfloat16,
    rwkv6-1.6b's 16 of 32, zamba2-2.7b's 40 of 80 with B and C shared;
    against their plain versions within phase 3's limits."""
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd, ssd_plain
    from repro_torch.kernels.wkv import wkv6, wkv6_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(4, 16, 256, 64, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    _close_bf16(ops.flash_attention(q, k, v, causal=True), flash_attention_ref(q, k, v, True))
    args = _wkv_args(cuda, 4 * 16, 256, 64)
    for got, want in zip(wkv6(*args, 64), wkv6_plain(*args, 64)):
        _close(got, want)
    args = _ssd_args(cuda, 4 * 40, 256, 64, 64, hshare=40)
    for got, want in zip(ssd(*args, 64, hshare=40), ssd_plain(*args, 64, hshare=40)):
        _close(got, want)


# ---------------------------------------------------------------------------
# storage dtypes: bfloat16 and float64 instantiations of the solver kernels,
# bfloat16 scan tensors
# ---------------------------------------------------------------------------
#
# Each (kernel, dtype) against its plain version on the card, on the same
# storage: bfloat16 element by element within one bfloat16 step of the
# plain value plus 1e-4 of its largest value (both compute in float32 from
# the same bfloat16 inputs and round each output once; the float32 sums
# run in another order, compounding over the block rows, as in _close);
# float64 within 1e-10 of the largest plain value (both compute in float64).

NEW_DTYPES = [torch.bfloat16, torch.float64]


def _close_dtype(kernel, plain):
    assert kernel.dtype == plain.dtype
    if kernel.dtype == torch.bfloat16:
        _close_bf16(kernel, plain, atol=1e-4)
    else:
        assert bool(torch.isfinite(kernel).all())
        diff = float((kernel - plain).abs().max())
        assert diff <= 1e-10 * max(float(plain.abs().max()), 1e-300)


# (n, k, p): K = 37 takes the element-copy ring in every dtype, K = 20 the
# bulk route in float32 / float64 and not in bfloat16 (20 % 8), K = 200
# and 256 the bulk route in all three; 200 and 256 grow the float64 cluster
DTYPE_SHAPES = [(259, 37, 3), (3200, 20, 8), (12800, 200, 4), (1400, 256, 2)]


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("n,k,p", DTYPE_SHAPES)
def test_solver_kernels_in_each_storage_dtype(cuda, dtype, n, k, p):
    """btf, bts (R = 1, 4 and K) and the fused pass through the wrappers,
    each launching its dtype's instantiation."""
    bt = _split(cuda, n, k, p)
    d, e, f = (x.to(dtype) for x in (bt.d, bt.e, bt.f))
    before = [btf.by_dtype.get(dtype, 0), bts.by_dtype.get(dtype, 0),
              fused_factor_spike.by_dtype.get(dtype, 0)]
    sinv, l = btf(d, e, f)
    ref = bl.btf_ref(d, e, f)
    _close_dtype(sinv, ref.sinv)
    _close_dtype(l, ref.l)
    for r in (1, 4, k):
        rhs = torch.randn(d.shape[:3] + (r,), device=cuda).to(dtype)
        _close_dtype(bts(ref.sinv, ref.l, f, rhs), bl.bts_ref(ref, rhs))
    bq, cq = (x.to(dtype) for x in bl.pad_couplings(bt.b_cpl, bt.c_cpl, p))
    for got, want in zip(fused_factor_spike(d, e, f, bq, cq),
                         bl.fused_factor_spike_padded_ref(d, e, f, bq, cq)):
        _close_dtype(got, want)
    assert [btf.by_dtype[dtype], bts.by_dtype[dtype], fused_factor_spike.by_dtype[dtype]] == [
        before[0] + 1, before[1] + 3, before[2] + 1]


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("n,k,p", [(259, 37, 3), (3200, 20, 8), (12800, 200, 4)])
def test_bts_copy_routes_and_clusters_in_each_dtype(cuda, dtype, n, k, p):
    """bts forced onto cluster sizes 0 (one block), 1, 2 and 16 in each
    dtype: the bulk route when a block row is a multiple of 16 bytes (K % 8
    in bfloat16, K % 2 in float64), element copies else."""
    from repro_torch.kernels import build

    bt = _split(cuda, n, k, p)
    d, e, f = (x.to(dtype) for x in (bt.d, bt.e, bt.f))
    ref = bl.btf_ref(d, e, f)
    lib = build.load("bts")
    bulk = entry(lib, "bts_bulk_route", dtype)(ref.sinv.data_ptr(), ref.l.data_ptr(),
                                               f.data_ptr(), k)
    assert bulk == (k * d.element_size() % 16 == 0)
    b = torch.randn(d.shape[:3] + (1,), device=cuda).to(dtype)
    for cluster in (0, 1, 2, 16):
        x, code = _bts_on(cuda, ref, b, cluster)
        build.check(lib, code, f"bts (cluster {cluster}, {dtype})")
        torch.cuda.synchronize()
        _close_dtype(x, bl.bts_ref(ref, b))


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("n,k,p", [(259, 37, 3), (12800, 200, 4)])
def test_btf_and_fused_routes_in_each_dtype(cuda, dtype, n, k, p):
    """btf and the fused pass on the one-block kernel (0), the wrapper's
    cluster size and 16 CTAs, in each dtype."""
    from repro_torch.kernels import build

    bt = _split(cuda, n, k, p)
    d, e, f = (x.to(dtype) for x in (bt.d, bt.e, bt.f))
    bq, cq = (x.to(dtype) for x in bl.pad_couplings(bt.b_cpl, bt.c_cpl, p))
    ref = bl.btf_ref(d, e, f)
    want = bl.fused_factor_spike_padded_ref(d, e, f, bq, cq)
    sizes = {0, 16, entry(build.load("btf"), "btf_cluster_size", dtype)(p, k),
             entry(build.load("fused_spike"), "fused_cluster_size", dtype)(p, k)}
    for cluster in sorted(sizes):
        sinv, l = _btf_on(cuda, d, e, f, cluster)
        torch.cuda.synchronize()
        _close_dtype(sinv, ref.sinv)
        _close_dtype(l, ref.l)
        for got, w in zip(_fused_on(cuda, d, e, f, bq, cq, cluster), want):
            _close_dtype(got, w)


def test_float64_slab_takes_a_larger_cluster(cuda):
    """The float64 slab is twice the bytes: at K = 200 a chain needs at least
    4 CTAs (float32 1), the SaP-E reduced chain's 2K = 400 takes 16 in btf
    (1.3 MB across the cluster) and in the BCR inverse (float32 4)."""
    from repro_torch.kernels import build

    lib = build.load("btf")
    assert entry(lib, "btf_cluster_size", torch.float64)(64, 200) >= 4
    assert entry(lib, "btf_cluster_size", torch.float64)(1, 400) == 16
    bcr = build.load("bcr")
    assert (bcr.bcr_inv_cluster_size(400), bcr.bcr_inv_cluster_size_f64(400)) == (4, 16)


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("m,k", [(16, 37), (64, 400)])
def test_bcr_kernels_in_each_dtype(cuda, dtype, m, k):
    """inv_odd, reduce, rhs_reduce and backsub through the wrappers at every
    level of a chain's factor and solve, each on the plain levels' operands
    (in bfloat16 each level rounds its outputs, so a whole chain run through
    the kernels drifts from the plain one by more than a step), R = 1, 4
    and 9 (the tiled kernels); then the whole ops.bcr_factor / bcr_solve,
    each wrapper counting its launches under the dtype, x normwise within
    1e-2 (bfloat16) or 1e-10 (float64) of the plain chain's."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr

    d, e, f, _ = (x.to(dtype) for x in _bcr_chain(cuda, m, k, 1, seed=k))
    e[0] = 0.0
    f[-1] = 0.0
    wrappers = (bcr.inv_odd, bcr.reduce, bcr.rhs_reduce, bcr.backsub)
    before = [w.by_dtype.get(dtype, 0) for w in wrappers]
    dd, ee, ff = cr.pad_chain(d, e, f)
    levels = []
    while dd.shape[0] > 1:
        a = cr.bcr_inv_odd_ref(dd)
        _close_dtype(bcr.inv_odd(dd), a)
        want = cr.bcr_reduce_ref(dd, ee, ff, a)
        for got, w in zip(bcr.reduce(dd, ee, ff, a), want):
            _close_dtype(got, w)
        levels.append((want[0], want[1], a, ee[1::2].contiguous(), ff[1::2].contiguous()))
        dd, ee, ff = want[2:]
    for r in (1, 4, 9):
        b = torch.randn(2 * levels[0][0].shape[0], k, r, device=cuda).to(dtype)
        rhs = []
        for lo, hi, *_ in levels:
            rhs.append(b)
            want = cr.bcr_rhs_reduce_ref(lo, hi, b)
            _close_dtype(bcr.rhs_reduce(lo, hi, b), want)
            b = want
        x = (cr.bcr_inv_odd_ref(dd, first=0)[0] @ b[0])[None]
        for (lo, hi, a, eo, fo), bl_ in zip(reversed(levels), reversed(rhs)):
            want = cr.bcr_backsub_ref(a, eo, fo, bl_, x)
            _close_dtype(bcr.backsub(a, eo, fo, bl_, x), want)
            x = want
    got, want = ops.bcr_factor(d, e, f), cr.bcr_factor(d, e, f)
    h = torch.randn(m, k, 1, device=cuda).to(dtype)
    gx, wx = ops.bcr_solve(got, h).double(), cr.bcr_solve(want, h).double()
    assert float((gx - wx).abs().max()) <= (1e-2 if dtype == torch.bfloat16 else 1e-10) * float(
        wx.abs().max())
    assert all(w.by_dtype[dtype] > n for w, n in zip(wrappers, before))


@pytest.mark.parametrize("variant,reduced", [("D", "auto"), ("C", "auto"), ("E", "chain"),
                                             ("E", "bcr")])
def test_lifecycle_in_each_precond_dtype_on_the_card(cuda, variant, reduced):
    """factor / solve on the card with a float64 preconditioner (BiCGStab(2)
    at tol 1e-10: true residual <= 1e-9, x within 1e-9 of the CPU's) and a
    bfloat16 one under refinement (true residual <= tol), against the same
    run on the CPU (plain versions)."""
    band = random_banded(4000, 10, 1.0 if variant != "E" else 0.5, seed=1)
    b = np.random.default_rng(2).normal(size=4000)
    for pdt, solver, tol in (("float64", "bicgstab2", 1e-10), ("bfloat16", "refine", 1e-8)):
        opts = SaPOptions(p=16, variant=variant, reduced_solver=reduced, tol=tol,
                          precond_dtype=pdt, solver=solver)
        gfac = factor(plan_banded(band, opts))
        assert gfac.pc.lu.sinv.dtype == getattr(torch, pdt)
        gpu = gfac.solve(b)
        cpu = factor(plan_banded(band, opts, device="cpu")).solve(b)
        assert float(gpu.true_resnorm) <= (1e-9 if pdt == "float64" else tol)
        if pdt == "float64":
            diff = float((gpu.x.cpu() - cpu.x).norm() / cpu.x.norm())
            assert diff <= 1e-9, diff


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("k", [190, 400, 800])
def test_inv_odd_with_boosts_in_each_dtype(cuda, dtype, k):
    """The odd-block inverse in each dtype on the route its block size
    picks (800: the one-block kernel, its elimination block in a compute-
    dtype workspace for bfloat16), with boosted pivots and exactly zero
    rows and columns, which invert to the identity."""
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.kernels import bcr

    d = _bcr_chain(cuda, 6, k, 1, seed=k)[0]
    boosted = [1, k // 3, k - 2]
    d[:, boosted, boosted] = 0.0
    zero = [0, k // 2, k - 1]
    d[3, zero, :] = 0.0
    d[3, :, zero] = 0.0
    d = d.to(dtype)
    before = bcr.inv_odd.by_dtype.get(dtype, 0)
    got = bcr.inv_odd(d, 0.05)
    _close_dtype(got, cr.bcr_inv_odd_ref(d, 0.05))
    eye = torch.eye(k, device=cuda, dtype=dtype)
    assert torch.equal(got[1][zero], eye[zero]) and torch.equal(got[1][:, zero], eye[:, zero])
    assert bcr.inv_odd.by_dtype[dtype] == before + 1


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("k", [37, 20, 400])
def test_bcr_solve_kernels_at_forced_routes_in_each_dtype(cuda, dtype, k):
    """rhs_reduce and backsub on the tiled kernels (0) and on splits /
    clusters of 1, 4 and 16, in each dtype: element copies for K = 37 in
    every dtype and for K = 20 in bfloat16 (40 bytes a row), bulk rows for
    K = 20 in float64 and for 400."""
    from repro_torch.core import cyclic_reduction as cr

    for r in (1, 3):
        lo, hi, a, e, f, b, x = (t.to(dtype) for t in _solve_level(cuda, 4, k, r, seed=k))
        for size in (0, 1, 4, 16):
            _close_dtype(_rhs_on(lo, hi, b, size), cr.bcr_rhs_reduce_ref(lo, hi, b))
            _close_dtype(_backsub_on(a, e, f, b, x, size), cr.bcr_backsub_ref(a, e, f, b, x))


@pytest.mark.parametrize("dtype", NEW_DTYPES)
def test_reduce_at_every_tile_in_each_dtype(cuda, dtype):
    from repro_torch.core import cyclic_reduction as cr

    for m2, k in ((2, 190), (32, 400)):
        d, e, f, _ = (x.to(dtype) for x in _bcr_chain(cuda, 2 * m2, k, 1, seed=m2 + k))
        e[0] = 0.0
        f[-1] = 0.0
        a = _bcr_chain(cuda, m2, k, 1, seed=k)[0].to(dtype)
        for tile in (96, 80, 64, 32):
            for got, want in zip(_reduce_on(d, e, f, a, tile), cr.bcr_reduce_ref(d, e, f, a)):
                _close_dtype(got, want)


@pytest.mark.parametrize("bh,t,d,chunk,route", WKV_ROUTE_SHAPES)
def test_wkv_in_bfloat16_on_every_route(cuda, bh, t, d, chunk, route):
    """bfloat16 r, k, v, log w (u and the state float32): o in bfloat16 within
    one step of the plain version's, the state in float32 within 1e-4."""
    from repro_torch.kernels.wkv import wkv6, wkv6_plain

    r, k, v, logw, u, s0 = _wkv_args(cuda, bh, t, d)
    args = (r.bfloat16(), k.bfloat16(), v.bfloat16(), logw.bfloat16(), u, s0)
    before = (wkv6.by_route[route], wkv6.by_dtype.get(torch.bfloat16, 0))
    o, s = wkv6(*args, chunk)
    assert (wkv6.by_route[route], wkv6.by_dtype[torch.bfloat16]) == (before[0] + 1, before[1] + 1)
    po, ps = wkv6_plain(*args, chunk)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close_bf16(o, po, atol=1e-4)
    _close(s, ps)


@pytest.mark.parametrize("bh,t,n,p,chunk,hshare,route",
                         [(320, 1, 64, 64, 1, 80, "step"), (320, 512, 64, 64, 64, 80, "split"),
                          (6, 74, 64, 64, 37, 3, "split"), (4, 32, 6, 8, 16, 1, "block")])
def test_ssd_in_bfloat16_on_every_route(cuda, bh, t, n, p, chunk, hshare, route):
    from repro_torch.kernels.ssd import ssd, ssd_plain

    x, bm, cm, la, s0 = _ssd_args(cuda, bh, t, n, p, hshare)
    args = (x.bfloat16(), bm.bfloat16(), cm.bfloat16(), la, s0)
    before = ssd.by_route[route]
    y, s = ssd(*args, chunk, hshare=hshare)
    assert ssd.by_route[route] == before + 1
    py, ps = ssd_plain(*args, chunk, hshare=hshare)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close_bf16(y, py, atol=1e-4)
    _close(s, ps)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_reduced_model_with_bfloat16_scans_on_the_card_matches_the_cpu(cuda, arch):
    """scan_dtype="bfloat16": forward and decode_step of the reduced model
    on the card (the scans' bfloat16 instantiations) against the same
    parameters on the CPU (plain versions, the same bfloat16 scan inputs):
    within 1e-2 of the largest logit -- bfloat16 outputs that may round a
    step apart feed the following layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6
    from repro_torch.models import get_family

    cfg = dataclasses.replace(get_config(arch, reduced=True), scan_dtype="bfloat16")
    fam = get_family(cfg)
    cpu_params = fam.init(cfg, device="cpu")
    gpu_params = fam.init(cfg, device="cpu").to(cuda)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 32)))
    bf = torch.bfloat16
    before = wkv6.by_dtype.get(bf, 0) + ssd.by_dtype.get(bf, 0)

    def close(got, want):
        assert float((got.cpu() - want).abs().max()) <= 1e-2 * float(want.abs().max())

    got, _ = fam.forward(cfg, gpu_params, toks.to(cuda))
    close(got, fam.forward(cfg, cpu_params, toks)[0])
    cache_g = fam.init_cache(cfg, 2, 16)
    cache_c = fam.init_cache(cfg, 2, 16, device="cpu")
    for i in range(4):
        lg, cache_g = fam.decode_step(cfg, gpu_params, cache_g, toks[:, i:i + 1].to(cuda))
        lc, cache_c = fam.decode_step(cfg, cpu_params, cache_c, toks[:, i:i + 1])
        close(lg, lc)
    assert wkv6.by_dtype.get(bf, 0) + ssd.by_dtype.get(bf, 0) >= before + 5 * cfg.n_layers


def test_bfloat16_scans_train_through_the_autograd_functions(cuda):
    """WKV6 with bfloat16 scan tensors that require grad: the forward on the
    kernel, one recompute in backward, gradients in the inputs' dtypes (u
    float32) close to autograd of the plain version at the same inputs."""
    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels.wkv import wkv6_plain

    r, k, v, logw, u, s0 = _wkv_args(cuda, 4, 64, 64)
    base = [t.bfloat16() for t in (r, k, v, logw)] + [u]
    got = [t.clone().requires_grad_(True) for t in base]
    before = kgrad.backward_calls["wkv6"]
    o, _ = ops.wkv6(*(t[None] for t in got[:4]), got[4], s0[None], chunk=16)
    o.float().square().sum().backward()
    assert kgrad.backward_calls["wkv6"] == before + 1
    want = [t.clone().requires_grad_(True) for t in base]
    wkv6_plain(*want, s0, 16)[0].float().square().sum().backward()
    for g, w in zip(got, want):
        assert g.grad.dtype == g.dtype
        err = float((g.grad.double() - w.grad.double()).abs().max())
        assert err <= 2e-2 * float(w.grad.double().abs().max())


# ---------------------------------------------------------------------------
# remat: each layer's forward replayed in the backward, on the card
# ---------------------------------------------------------------------------


def _remat_run(cuda, name, mode, b, t, layers):
    """(loss, {name: gradient}, kernel launches, peak bytes above the
    start) of one loss and backward of a reduced config at ``remat=mode``,
    float32 compute, the same weights and tokens at every mode."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6
    from repro_torch.models import get_family

    cfg = dataclasses.replace(get_config(name, reduced=True), remat=mode, n_layers=layers)
    fam = get_family(cfg)
    model = fam.init(cfg, torch.Generator(cuda).manual_seed(0), device=cuda).requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=torch.Generator().manual_seed(1))
    wrappers = (flash_attention, wkv6, ssd)
    before = [w.launches for w in wrappers]
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = fam.loss(cfg, model, {"tokens": tokens.to(cuda)})
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    launches = {w.__name__: w.launches - n for w, n in zip(wrappers, before)}
    return float(loss.detach()), {n: p.grad.detach() for n, p in model.named_parameters()}, \
        launches, peak


@pytest.mark.parametrize("name,kernel", [("stablelm-1.6b", "flash_attention"),
                                         ("rwkv6-1.6b", "wkv6"), ("zamba2-2.7b", "ssd")])
def test_remat_replays_the_kernels_under_the_checkpoint(cuda, name, kernel):
    """At "full" and "dots" the backward replays each layer's forward, so
    the family's kernel launches twice a layer where "none" launches once;
    the loss and the gradients equal "none"'s (the same kernels on the same
    inputs)."""
    runs = {m: _remat_run(cuda, name, m, 2, 128, 4) for m in ("none", "full", "dots")}
    base = runs["none"]
    for mode in ("full", "dots"):
        loss, grads, launches, _ = runs[mode]
        assert launches[kernel] == 2 * base[2][kernel], (mode, launches, base[2])
        assert loss == base[0]
        for n, g in base[1].items():
            err = float((grads[n] - g).abs().max())
            assert err <= 1e-6 * max(float(g.abs().max()), 1e-30), (mode, n, err)


def test_remat_full_peaks_below_none_on_the_card(cuda):
    """stablelm reduced at 8 layers, B = 8, T = 512: the peak of a loss and
    backward at "full" below "dots" below "none" (a layer's activations
    kept at a time, against every layer's)."""
    peaks = {m: _remat_run(cuda, "stablelm-1.6b", m, 8, 512, 8)[3]
             for m in ("none", "dots", "full")}
    assert peaks["full"] < peaks["dots"] < peaks["none"], peaks
