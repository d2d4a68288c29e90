"""The port's block cyclic reduction against the JAX package.

The plain ``bcr_factor`` / ``bcr_solve`` and the kernel wrappers' CPU path
(``repro_torch.kernels.ops``) against the jnp reference
(``repro.core.cyclic_reduction``) and the Pallas kernels in interpret
mode without lane padding (``repro.kernels.bcr``), level leaf by level
leaf; against the port's own sequential chain sweep; and the SaP-E
lifecycle with ``reduced_solver`` "bcr" / "auto" against the JAX
lifecycle.

Tolerance: rtol = atol = 2e-4, the JAX package's own BCR tests' -- the
same float32 elimination with the block products' sums taken in another
order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs.sap_solver import exact
from repro.core import cyclic_reduction as jcr
from repro.kernels.bcr import bcr_factor_pallas, bcr_solve_pallas
import repro_torch.core as T
from repro_torch.core import block_lu as tbl
from repro_torch.core import cyclic_reduction as tcr
from repro_torch.core import spike as ts
from repro_torch.kernels import bcr as kbcr
from repro_torch.kernels import build, ops

TOL = dict(rtol=2e-4, atol=2e-4)


def _chain(m, k, r, seed):
    rng = np.random.default_rng(seed)
    sc = min(1.0, 8 / k)  # keeps the 4 I shift dominant at K = 37 (B3)
    d = (sc * rng.normal(size=(m, k, k)) + 4 * np.eye(k)).astype(np.float32)
    e = (sc * rng.normal(size=(m, k, k)) * 0.3).astype(np.float32)
    f = (sc * rng.normal(size=(m, k, k)) * 0.3).astype(np.float32)
    b = rng.normal(size=(m, k, r)).astype(np.float32)
    return d, e, f, b


def _torch(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _assert_factors_close(tf, jf):
    assert tf.m == jf.m and tf.n_levels == jf.n_levels
    for tl, jl in zip(tf.levels, jf.levels):
        for name in tcr.BCRLevel._fields:
            np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                       err_msg=name, **TOL)
    np.testing.assert_allclose(tf.root_inv.numpy(), np.asarray(jf.root_inv), **TOL)


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 16])
def test_bcr_matches_jax_reference(m, k, r):
    d, e, f, b = _chain(m, k, r, seed=100 * m + 10 * k + r)
    jf = jcr.bcr_factor(jnp.asarray(d), jnp.asarray(e), jnp.asarray(f))
    jx = jcr.bcr_solve(jf, jnp.asarray(b))
    tf = tcr.bcr_factor(*_torch(d, e, f))
    _assert_factors_close(tf, jf)
    np.testing.assert_allclose(tcr.bcr_solve(tf, torch.tensor(b)).numpy(), np.asarray(jx), **TOL)


# besides: K = 37, which no reduce tile size (96, 80, 64, 32) divides, at
# m/2 = 1 (m = 2) and through three levels (m = 5, padded to 8)
@pytest.mark.parametrize("m,k,r", [(1, 2, 1), (2, 4, 3), (3, 8, 1), (5, 2, 3), (8, 4, 1), (16, 8, 3),
                                   (2, 37, 1), (5, 37, 2)])
def test_bcr_kernel_path_matches_jax_interpret_kernels(m, k, r):
    """The kernel wrappers' CPU path (ops.bcr_factor / bcr_solve, level by
    level through the four wrappers) against the Pallas kernels run in
    interpret mode, without the TPU lane padding."""
    d, e, f, b = _chain(m, k, r, seed=m + k + r)
    jf = bcr_factor_pallas(jnp.asarray(d), jnp.asarray(e), jnp.asarray(f), interpret=True,
                           lane_pad=False)
    jx = bcr_solve_pallas(jf, jnp.asarray(b), interpret=True, lane_pad=False)
    tf = ops.bcr_factor(*_torch(d, e, f))
    _assert_factors_close(tf, jf)
    np.testing.assert_allclose(ops.bcr_solve(tf, torch.tensor(b)).numpy(), np.asarray(jx), **TOL)


@pytest.mark.parametrize("m", [1, 3, 6, 9])
def test_kernel_path_on_cpu_is_the_plain_version(m, monkeypatch):
    """On CPU tensors the wrappers run the plain versions, bit for bit, and
    neither build nor count a launch."""

    def no_build(name):
        raise AssertionError(f"kernel {name} must not be built for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    wrappers = (kbcr.inv_odd, kbcr.reduce, kbcr.rhs_reduce, kbcr.backsub)
    before = [w.launches for w in wrappers]
    d, e, f, b = _torch(*_chain(m, 4, 2, seed=m))
    got = ops.bcr_factor(d, e, f)
    want = tcr.bcr_factor(d, e, f)
    for gl, wl in zip(got.levels, want.levels):
        for g, w in zip(gl, wl):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(got.root_inv, want.root_inv, rtol=0, atol=0)
    torch.testing.assert_close(ops.bcr_solve(got, b), tcr.bcr_solve(want, b), rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("m,k", [(1, 3), (2, 2), (7, 4), (12, 3)])
def test_bcr_matches_the_port_chain_sweep(m, k):
    """BCR and the sequential btf/bts sweep solve the same chain; a chain of
    one block row reduces to the root inverse, which is btf's inverse."""
    d, e, f, b = _torch(*_chain(m, k, 2, seed=7 * m + k))
    x_seq = tbl.bts_chain(tbl.btf_chain(d, e, f), b)
    x_bcr = ops.bcr_solve(ops.bcr_factor(d, e, f), b)
    torch.testing.assert_close(x_bcr, x_seq, **TOL)
    one = ops.bcr_factor(d[:1], e[:1], f[:1])
    assert one.n_levels == 0
    torch.testing.assert_close(one.root_inv, tbl.btf_chain(d[:1], e[:1], f[:1]).sinv[0, 0], **TOL)


def test_pad_chain_leaves_the_callers_tensors_alone():
    d, e, f, _ = _torch(*_chain(5, 3, 1, seed=1))
    e0, f0 = e.clone(), f.clone()
    pd, pe, pf = tcr.pad_chain(d, e, f)
    torch.testing.assert_close(e, e0, rtol=0, atol=0)
    torch.testing.assert_close(f, f0, rtol=0, atol=0)
    assert pd.shape == (8, 3, 3) and bool((pe[0] == 0).all()) and bool((pf[4:] == 0).all())
    torch.testing.assert_close(pd[5:], torch.eye(3).expand(3, 3, 3))


def test_identity_padding_inverts_to_the_identity():
    """The structural-zero pivot rule: padded identity blocks invert to the
    identity, so the padding carries the zero solution."""
    d, e, f, b = _torch(*_chain(3, 4, 2, seed=3))
    fac = ops.bcr_factor(d, e, f)
    torch.testing.assert_close(fac.levels[0].a_odd[1], torch.eye(4), rtol=0, atol=0)
    x = ops.bcr_solve(fac, b)
    assert x.shape == b.shape


def test_reduced_solver_policy_matches_jax():
    for m in (1, 7, 8, 63):
        for choice in ("chain", "bcr", "auto"):
            assert tcr.resolve_reduced_solver(choice, m) == jcr.resolve_reduced_solver(choice, m)
    with pytest.raises(ValueError):
        tcr.resolve_reduced_solver("nope", 4)


# ---------------------------------------------------------------------------
# SaP-E with BCR through the lifecycle
# ---------------------------------------------------------------------------


def _osc_system(n=512, k=6, d=0.5, seed=1):
    band = J.oscillatory_banded(n, k, d=d, seed=seed).astype(np.float32)
    dense = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    xstar = np.random.default_rng(seed + 1).normal(size=n)
    return band, (dense @ xstar).astype(np.float32), xstar


def test_bcr_on_the_interface_chain_matches_jax():
    """The SaP-E reduced chain of that system (P = 16: 15 interfaces of
    2K = 12 blocks) factored and solved by the port's kernel path and by
    the jnp reference: the same chain in, the same levels out."""
    band, _, _ = _osc_system()
    bt = T.band_to_block_tridiag(torch.tensor(band), 6, 16)
    fs = tbl.fused_factor_spike_ref(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    rd, re, rf = ts._reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
    tf = ops.bcr_factor(rd, re, rf)
    jf = jcr.bcr_factor(*(jnp.asarray(x.numpy()) for x in (rd, re, rf)))
    _assert_factors_close(tf, jf)
    h = np.random.default_rng(4).normal(size=(15, 12, 2)).astype(np.float32)
    np.testing.assert_allclose(ops.bcr_solve(tf, torch.tensor(h)).numpy(),
                               np.asarray(jcr.bcr_solve(jf, jnp.asarray(h))), **TOL)


@pytest.mark.parametrize("reduced_solver", ["bcr", "auto"])
def test_variant_e_lifecycle_with_bcr_matches_jax(reduced_solver):
    """oscillatory d = 0.5 at P = 16: 15 interfaces, so "auto" is "bcr" in
    both packages.  The spike corners of this system already differ by a
    few 1e-3 of their size between the packages in float32 (the chain is
    ill-conditioned), so the answers are compared, not the factors: x
    within 1e-4 of the JAX x (normwise) and near x*."""
    band, b, xstar = _osc_system()
    kw = dict(p=16, variant="E", tol=1e-5, maxiter=50, reduced_solver=reduced_solver)
    jfac = J.factor(J.plan_banded(jnp.asarray(band), J.SaPOptions(**kw)))
    tfac = T.factor(T.plan_banded(band, T.SaPOptions(**kw), device="cpu"))
    assert tfac.pc.reduced_solver == jfac.pc.reduced_solver == "bcr"
    assert tfac.pc.red_lu is None
    assert tfac.pc.red_bcr.n_levels == jfac.pc.red_bcr.n_levels == 4
    assert tfac.pc.red_bcr.m == jfac.pc.red_bcr.m == 15
    tres, jres = tfac.solve(b), jfac.solve(jnp.asarray(b))
    tx, jx = tres.x.numpy(), np.asarray(jres.x)
    assert np.linalg.norm(tx - jx) <= 1e-4 * np.linalg.norm(jx)
    assert float(tres.iterations) <= 3.0 and bool(tres.converged)
    assert np.linalg.norm(tx - xstar) / np.linalg.norm(xstar) < 1e-2


def test_exact_config_resolves_to_bcr_in_the_port():
    """The JAX package's exact() workload preset, mapped onto the port's
    options, factors as variant E with BCR at P = 16 (15 interfaces)."""
    jopts = exact().to_sap_options(p=16)
    fields = {f.name for f in dataclasses.fields(T.SaPOptions)}
    topts = T.SaPOptions(**{k: v for k, v in dataclasses.asdict(jopts).items() if k in fields})
    assert (topts.variant, topts.reduced_solver) == ("E", "auto")
    band = J.oscillatory_banded(512, 6, d=exact().d, seed=3).astype(np.float32)
    tfac = T.factor(T.plan_banded(band, topts, device="cpu"))
    jfac = J.factor(J.plan_banded(jnp.asarray(band), jopts))
    assert tfac.variant == jfac.variant == "E"
    assert tfac.pc.reduced_solver == jfac.pc.reduced_solver == "bcr"


def test_legacy_info_reports_bcr():
    band, b, _ = _osc_system()
    with pytest.warns(DeprecationWarning):
        sol = T.solve_banded(band, b, T.SaPOptions(p=16, variant="E", tol=1e-5), device="cpu")
    assert sol.info["reduced_solver"] == "bcr"


def _flatten_bcr(jfac):
    pc = jfac.pc
    arrays = {
        "op.band": jfac.op.band,
        "lu.sinv": pc.lu.sinv, "lu.l": pc.lu.l, "lu.f": pc.lu.f,
        "b_cpl": pc.b_cpl, "c_cpl": pc.c_cpl,
        "red_bcr.root_inv": pc.red_bcr.root_inv,
        "d_factor": jfac.d_factor,
    }
    for lvl, level in enumerate(pc.red_bcr.levels):
        for name in tcr.BCRLevel._fields:
            arrays[f"red_bcr.{lvl}.{name}"] = getattr(level, name)
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    meta = dict(variant=pc.variant, p=pc.p, m=pc.m, k=pc.k, tol=jfac.tol, maxiter=jfac.maxiter,
                solver=jfac.solver, red_bcr_m=pc.red_bcr.m)
    return arrays, meta


def test_carry_across_a_jax_bcr_factorization():
    band, b, _ = _osc_system()
    opts = J.SaPOptions(p=16, variant="E", tol=1e-5, maxiter=50, reduced_solver="bcr")
    jfac = J.factor(J.plan_banded(jnp.asarray(band), opts))
    tfac = T.factorization_from_numpy(*_flatten_bcr(jfac), device="cpu")
    assert tfac.pc.reduced_solver == "bcr" and tfac.pc.red_bcr.m == jfac.pc.red_bcr.m == 15
    assert tfac.pc.red_bcr.n_levels == jfac.pc.red_bcr.n_levels
    r = np.random.default_rng(9).normal(size=jfac.n_pad).astype(np.float32)
    tz, jz = tfac.pc.apply(torch.tensor(r)).numpy(), np.asarray(jfac.pc.apply(jnp.asarray(r)))
    # the same stored factors applied: only the solve's sums differ in order
    assert np.abs(tz - jz).max() <= 1e-5 * np.abs(jz).max()
    tx, jx = tfac.solve(b).x.numpy(), np.asarray(jfac.solve(jnp.asarray(b)).x)
    assert np.linalg.norm(tx - jx) <= 1e-4 * np.linalg.norm(jx)


def test_carry_across_rejects_unknown_bcr_leaves():
    with pytest.raises(ValueError, match="unknown"):
        T.factorization_from_numpy({"red_bcr.0.lower": np.zeros(1)}, {}, device="cpu")


# ---------------------------------------------------------------------------
# the cluster inverse's blocked Gauss-Jordan (csrc/bcr.cu, inv_cluster_kernel)
# ---------------------------------------------------------------------------


def _panel_gj_inverse(a, boost_eps, b):
    """The cluster kernel's algorithm in numpy float32, in the in-place form
    of its slab: for each panel P of b columns, (i) copy the strip of pivot
    rows, (ii) run the b unblocked steps on the copy -- the pivot, its
    boost below boost_eps max|A|, the structural-zero test of W[t, t:] --
    (iii) update every row outside P as (row, P columns zeroed) - row[P] R,
    (iv) write the processed strip R into the panel rows.  Returns the
    inverse and the number of boosted pivots."""
    k = a.shape[0]
    w = a.astype(np.float32)
    thr = np.float32(boost_eps) * max(np.abs(w).max(), np.float32(1e-30))
    boosts = 0
    for t0 in range(0, k, b):
        p = np.arange(t0, min(t0 + b, k))
        r = w[p].copy()  # (i)
        for j, t in enumerate(p):  # (ii)
            col = r[:, t].copy()
            piv = col[j]
            nz = bool((r[j, t:] != 0).any())
            if abs(piv) < thr and nz:
                piv, boosts = (thr if piv >= 0 else -thr), boosts + 1
            piv = piv if nz else np.float32(1)
            rv = r[j] / piv
            rv[t] = np.float32(1) / piv
            r[:, t] = 0
            r -= np.outer(col, rv)
            r[j] = rv
        rest = np.setdiff1d(np.arange(k), p)  # (iii)
        wp = w[np.ix_(rest, p)].copy()
        w[np.ix_(rest, p)] = 0
        w[rest] -= wp @ r
        w[p] = r  # (iv)
    return w, boosts


@pytest.mark.parametrize("k", [7, 40, 100])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_panel_gauss_jordan_matches_the_plain_and_jax_inverse(b, k):
    """Panels of 1 (the unblocked steps), 8 and 32 columns, a last panel
    that is partial, pivots boosted under boost_eps = 0.05 (zeroed
    diagonal entries), and rows and columns that are exactly zero, which
    invert to the identity."""
    from repro.core.block_lu import gj_inverse as jax_gj_inverse

    rng = np.random.default_rng(k + b)
    a = (k**-0.5 * rng.normal(size=(k, k)) + 4 * np.eye(k)).astype(np.float32)
    boosted, zero = [1, k // 3, k - 2], [0, k // 2, k - 1]
    a[boosted, boosted] = 0
    a[zero, :] = 0
    a[:, zero] = 0
    got, boosts = _panel_gj_inverse(a, 0.05, b)
    assert boosts > 0
    np.testing.assert_array_equal(got[zero], np.eye(k, dtype=np.float32)[zero])
    np.testing.assert_array_equal(got[:, zero], np.eye(k, dtype=np.float32)[:, zero])
    want = tcr.bcr_inv_odd_ref(torch.tensor(a)[None], 0.05, first=0)[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_gj_inverse(jnp.asarray(a), 0.05)), **TOL)



# ---------------------------------------------------------------------------
# the tiled reduce (csrc/bcr.cu, reduce_kernel)
# ---------------------------------------------------------------------------


def _tiled_reduce(d, e, f, a, bm):
    """reduce_kernel's bookkeeping in numpy float32: each BM x BM output tile
    of a level's products from operands zero-padded past K, the depth in
    slices of 16; lo_i = E_2i a_max(i-1,0) and hi_i = F_2i a_i, then D'_i =
    D_2i - (lo_i F_p + hi_i E_2i+1) as one sum over both products' slices,
    E'_i = -(lo_i E_p), F'_i = -(hi_i F_2i+1), p = max(2i-1, 0)."""
    m2, k = a.shape[0], a.shape[1]
    kp, dp = -(-k // bm) * bm, -(-k // 16) * 16

    def padded(x, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        out[: x.shape[0], : x.shape[1]] = x
        return out

    def product(pairs):
        c = np.zeros((kp, kp), np.float32)
        for r0 in range(0, kp, bm):
            for c0 in range(0, kp, bm):
                acc = np.zeros((bm, bm), np.float32)
                for A, B in pairs:
                    ap, bp = padded(A, kp, dp), padded(B, dp, kp)
                    for k0 in range(0, dp, 16):
                        acc += ap[r0:r0 + bm, k0:k0 + 16] @ bp[k0:k0 + 16, c0:c0 + bm]
                c[r0:r0 + bm, c0:c0 + bm] = acc
        return c[:k, :k]

    outs = [np.empty((m2, k, k), np.float32) for _ in range(5)]
    for i in range(m2):
        p = max(2 * i - 1, 0)
        lo = product([(e[2 * i], a[max(i - 1, 0)])])
        hi = product([(f[2 * i], a[i])])
        outs[0][i], outs[1][i] = lo, hi
        outs[2][i] = d[2 * i] - product([(lo, f[p]), (hi, e[2 * i + 1])])
        outs[3][i] = -product([(lo, e[p])])
        outs[4][i] = -product([(hi, f[2 * i + 1])])
    return outs


@pytest.mark.parametrize("m,k", [(2, 37), (4, 37), (2, 70)])
@pytest.mark.parametrize("tile", [96, 80, 64, 32])
def test_tiled_reduce_model_matches_the_interpret_kernel_and_plain(m, k, tile):
    """Every tile size of reduce_kernel on a level whose K no tile divides
    (37, 70), at m/2 = 1 and 2, against the Pallas level in interpret mode
    (same inverses) and the port's plain reduce; E_0 = 0 as every level's
    chain has it.  Tolerance as the module's."""
    from repro.kernels.bcr import _reduce_level_pallas

    d, e, f, _ = _chain(m, k, 1, seed=10 * m + k + tile)
    e[0] = 0.0
    f[-1] = 0.0
    level, nxt = _reduce_level_pallas(jnp.asarray(d), jnp.asarray(e), jnp.asarray(f),
                                      tbl.DEFAULT_BOOST, True)
    a = np.asarray(level.a_odd)
    got = _tiled_reduce(d, e, f, a, tile)
    for g, w in zip(got, (level.lo, level.hi, *nxt)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    for g, w in zip(got, tcr.bcr_reduce_ref(*_torch(d, e, f, a))):
        np.testing.assert_allclose(g, w.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the solve kernels (csrc/bcr.cu: rhs_reduce_warp_kernel,
# backsub_cluster_kernel)
# ---------------------------------------------------------------------------


def _row_width(k):
    """Floats of the kernels' row copies for aligned blocks (solve_vec)."""
    return 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1


def _widest_split(k, cap=16):
    """The widest split the kernels' rule may take for 2K = k: the largest
    power of two up to ``cap`` leaving every CTA at least 8 rows (the
    small levels of every chain take it)."""
    s = 1
    while 2 * s <= cap and -(-k // (2 * s)) >= 8:
        s *= 2
    return s


def _warp_rows(blocks, vectors):
    """stage_dot in numpy float32: sum_m blocks[m] @ vectors[m] for (n, K)
    rows and (K, R) vectors, as a warp forms one row.  Lane l takes the
    pieces of VEC columns p VEC .. p VEC + VEC - 1, p = l, l + 32, ..., and
    sums them in order -- piece, element, the blocks' terms interleaved;
    then the butterfly (xor 16, 8, 4, 2, 1), after which column c is lane
    c's sum, as lane c stores it."""
    n, k = blocks[0].shape
    r = vectors[0].shape[1]
    vec = _row_width(k)
    kp = -(-k // (32 * vec)) * 32 * vec
    piece, elem = np.divmod(np.arange(kp), vec)
    rnd, lane = np.divmod(piece, 32)
    seq = rnd * vec + elem  # a column's place in its lane's order
    terms = np.zeros((n, r, 32, seq.max() + 1, len(blocks)), np.float32)
    for m, (rows, v) in enumerate(zip(blocks, vectors)):
        rp = np.zeros((n, kp), np.float32)
        rp[:, :k] = rows
        vp = np.zeros((kp, r), np.float32)
        vp[:k] = v
        terms[:, :, lane, seq, m] = (rp[:, :, None] * vp[None]).transpose(0, 2, 1)
    acc = np.zeros((n, r, 32), np.float32)
    for t in range(terms.shape[3]):
        for m in range(len(blocks)):
            acc = acc + terms[:, :, :, t, m]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ o]
    return acc[:, np.arange(r), np.arange(r)]


def _warp_rhs_reduce(lo, hi, b):
    """rhs_reduce_warp_kernel: out_i = b_2i - (lo_i b_max(2i-1,0) + hi_i
    b_2i+1), one warp a row."""
    out = np.empty((lo.shape[0],) + b.shape[1:], np.float32)
    for i in range(lo.shape[0]):
        out[i] = b[2 * i] - _warp_rows([lo[i], hi[i]], [b[max(2 * i - 1, 0)], b[2 * i + 1]])
    return out


def _cluster_backsub(a, e, f, b, x, cs):
    """backsub_cluster_kernel on clusters of cs CTAs: CTA c forms its rows
    [c n, c n + n) of t_i = b_2i+1 - (e_i x_i + f_i x_min(i+1,m2-1)), the
    whole t_i is gathered from the cluster's row slices, and CTA c forms its
    rows of a_i t_i; out_2i = x_i."""
    m2, k, _ = x.shape
    n = -(-k // cs)
    slices = [slice(c * n, min(c * n + n, k)) for c in range(cs) if c * n < k]
    out = np.empty((2 * m2,) + x.shape[1:], np.float32)
    for i in range(m2):
        nxt = x[min(i + 1, m2 - 1)]
        t = np.concatenate([b[2 * i + 1][sl] - _warp_rows([e[i][sl], f[i][sl]], [x[i], nxt])
                            for sl in slices])
        out[2 * i + 1] = np.concatenate([_warp_rows([a[i][sl]], [t]) for sl in slices])
        out[2 * i] = x[i]
    return out


def _pallas_level(kernel, m2, k, r, blocks, vectors, block_maps, vector_maps, out_rows):
    """One level of the JAX package's solve kernel (``_rhs_reduce_kernel`` or
    ``_backsub_kernel``) through ``pallas_call`` in interpret mode without
    lane padding, with the grid and index maps of ``bcr_solve_pallas``."""
    import jax
    from jax.experimental import pallas as pl
    from repro.kernels.bcr import _PARALLEL, _specs

    cur = lambda i: (i, 0, 0)  # noqa: E731
    out = pl.pallas_call(
        kernel, grid=(m2,), in_specs=_specs(k, k, *block_maps) + _specs(k, r, *vector_maps),
        out_specs=pl.BlockSpec((out_rows, k, r), cur),
        out_shape=jax.ShapeDtypeStruct((out_rows * m2, k, r), jnp.float32),
        interpret=True, compiler_params=_PARALLEL,
    )(*[jnp.asarray(t) for t in blocks + vectors])
    return np.asarray(out)


def _solve_level(m2, k, r, seed):
    """A level's operands as a chain gives them: lo_0 = 0 (E_0 = 0) and
    f_odd[m2-1] = 0 (the chain's tail), so the clamped neighbours the
    kernels read contribute nothing, as in every real level."""
    rng = np.random.default_rng(seed)
    lo, hi, a, e, f = ((rng.normal(size=(m2, k, k)) / np.sqrt(k)).astype(np.float32)
                       for _ in range(5))
    lo[0] = 0.0
    f[-1] = 0.0
    b = rng.normal(size=(2 * m2, k, r)).astype(np.float32)
    x = rng.normal(size=(m2, k, r)).astype(np.float32)
    return lo, hi, a, e, f, b, x


# 2K = 37 (4-byte rows), 70, 190 (8-byte: the sparse run's chain), 400
# (16-byte); m/2 = 1, 2, 3 so that both clamped neighbours are read
SOLVE_LEVELS = [(m2, k, r) for k in (37, 70, 190, 400) for m2 in (1, 2, 3) for r in (1, 4, 8)]


@pytest.mark.parametrize("m2,k,r", SOLVE_LEVELS)
def test_warp_rhs_reduce_model_matches_the_interpret_kernel_and_plain(m2, k, r):
    """The warp-per-row rhs_reduce against the Pallas level in interpret
    mode and the port's plain version.  Tolerance as the module's."""
    from repro.kernels.bcr import _rhs_reduce_kernel

    lo, hi, _, _, _, b, _ = _solve_level(m2, k, r, seed=100 * k + 10 * m2 + r)
    got = _warp_rhs_reduce(lo, hi, b)
    cur = lambda i: (i, 0, 0)  # noqa: E731
    want = _pallas_level(_rhs_reduce_kernel, m2, k, r, [lo, hi], [b, b, b], (cur, cur),
                         (lambda i: (2 * i, 0, 0), lambda i: (jnp.maximum(2 * i - 1, 0), 0, 0),
                          lambda i: (2 * i + 1, 0, 0)), 1)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, tcr.bcr_rhs_reduce_ref(*_torch(lo, hi, b)).numpy(), **TOL)


@pytest.mark.parametrize("m2,k,r", SOLVE_LEVELS)
def test_cluster_backsub_model_matches_the_interpret_kernel_and_plain(m2, k, r):
    """The one-launch backsub on the widest cluster its rule may take (up to
    16 CTAs, each at least 8 rows) against the Pallas level in interpret
    mode and the port's plain version.  Tolerance as the module's."""
    from repro.kernels.bcr import _backsub_kernel

    _, _, a, e, f, b, x = _solve_level(m2, k, r, seed=100 * k + 10 * m2 + r + 1)
    got = _cluster_backsub(a, e, f, b, x, _widest_split(k))
    cur = lambda i: (i, 0, 0)  # noqa: E731
    odd = b[1::2].copy()
    want = _pallas_level(_backsub_kernel, m2, k, r, [a, e, f], [odd, x, x], (cur, cur, cur),
                         (cur, cur, lambda i: (jnp.minimum(i + 1, m2 - 1), 0, 0)), 2)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, tcr.bcr_backsub_ref(*_torch(a, e, f, b, x)).numpy(), **TOL)
