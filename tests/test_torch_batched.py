"""The port's batched lifecycle (``repro_torch.core.batched``) against the
JAX package's, on the CPU.

The same seeded numpy bands go through ``repro.core.batched`` (jnp path,
float32, JAX x64 off) and through the port with ``device="cpu"``.

* Bucketing, padding and permutations: equal, bit for bit.
* ``solve_batch`` / ``solve_batch_many``: per system, ``x`` within a
  normwise relative difference of 1e-4 of the JAX ``x`` (float32 Krylov
  iterations whose sums run in another order), both ``true_resnorm`` at
  most 10 * tol, and equal iteration counts -- but at tol = 1e-8, below
  what float32 iterations reach reliably, within one sweep
  (``tests/test_torch_sap.py`` allows the same).  A single-RHS solve of
  one column of a many-RHS batch is held by its true residual and x: its
  float32 applies at R = 1 round differently, and an exit near tol may
  move.
* Against the port's own single-system solves: the same 1e-4.

The misconvergence cases of ``tests/test_misconvergence.py`` that concern
the batch (the interleaved K-widening embedding, structurally zero pivot
rows, the batched solve through a K-rounding bucket) are held here too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.banded import band_matvec as jax_matvec
from repro.core.banded import oscillatory_banded, random_banded

TOL = 1e-6
XTOL = 1e-4  # normwise, relative to the reference x


def _band(gen, n, k, d, seed):
    fn = oscillatory_banded if gen == "oscillatory" else random_banded
    return np.float32(fn(n, k, d=d, seed=seed))


def _system(n, k, d=1.0, seed=0, gen="random"):
    band = _band(gen, n, k, d, seed)
    x = np.random.default_rng(seed + 100).normal(size=n)
    b = np.asarray(jax_matvec(jnp.asarray(band), jnp.asarray(x, jnp.float32)))
    return band, x, b


def _close_x(got, want, tol=XTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _true_res(band, x, b):
    a = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    b = np.asarray(b, np.float64)
    return np.linalg.norm(b - a @ np.asarray(x, np.float64)) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# bucketing and padding: bit-equal to the JAX package
# ---------------------------------------------------------------------------

SHAPES = [(100, 3, 4), (4096, 16, 8), (10_001, 7, 16), (8, 1, 2), (1000, 5, 4), (16_384, 9, 16),
          (12_000, 12, 16), (64, 0, 2)]


@pytest.mark.parametrize("rounding", ["pow2", "exact"])
@pytest.mark.parametrize("n,k,p", SHAPES)
def test_bucket_shape_matches_jax(n, k, p, rounding):
    got = T.bucket_shape(n, k, p, rounding)
    assert got == J.bucket_shape(n, k, p, rounding)
    nb, kb, pb = got
    assert nb >= n and kb >= max(k, 2) and pb == p and nb % (p * kb) == 0
    assert T.bucket_shape(nb, kb, p, rounding) == got  # a bucket maps to itself
    assert T.interleaved_rows(n, k, kb) == J.interleaved_rows(n, k, kb)


@pytest.mark.parametrize("rounding", ["pow2", "exact"])
def test_bucket_by_shape_matches_jax(rounding):
    shapes = [(1000, 5), (900, 6), (1024, 8), (100, 2), (1000, 5), (16_384, 16), (10_000, 9)]
    got = T.bucket_by_shape(shapes, p=4, rounding=rounding)
    assert list(got.items()) == list(J.bucket_by_shape(shapes, p=4, rounding=rounding).items())
    with pytest.raises(ValueError, match="rounding"):
        T.bucket_shape(100, 3, 4, "nope")


# (n, k, n', k'): contiguous widening without interleave room, interleaved
# K-widening, N-only padding, no padding, K = 0
PADS = [(60, 4, 96, 7), (60, 3, 128, 4), (200, 5, 512, 8), (96, 3, 128, 3), (64, 4, 64, 4),
        (40, 0, 64, 2)]


@pytest.mark.parametrize("n,k,nb,kb", PADS)
def test_pad_band_to_and_permutation_bit_equal(n, k, nb, kb):
    band = _band("random", n, k, 1.2, seed=n)
    want = np.asarray(J.pad_band_to(jnp.asarray(band), nb, kb))
    got = T.pad_band_to(band, nb, kb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.pad_band_to(torch.tensor(band), nb, kb).numpy(), want)
    tperm, jperm = T.pad_permutation(n, k, nb, kb), J.pad_permutation(n, k, nb, kb)
    assert (tperm is None) == (jperm is None)
    if jperm is not None:
        assert tperm.dtype == jperm.dtype
        np.testing.assert_array_equal(tperm, jperm)
    rhs = np.random.default_rng(n).normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(T.pad_rhs_to(rhs, nb).numpy(), np.asarray(J.pad_rhs_to(rhs, nb)))


def test_pad_band_to_rejects_shrink():
    band, _, _ = _system(64, 3)
    with pytest.raises(ValueError, match="smaller"):
        T.pad_band_to(band, 32, 3)
    with pytest.raises(ValueError, match="smaller"):
        T.pad_band_to(band, 64, 2)


def test_padded_system_is_exactly_embedded():
    """Identity-row / zero-column padding decouples exactly: the dense
    padded matrix is blkdiag(A, I), so its solution is [x; 0]."""
    band, _, b = _system(60, 4, seed=3)
    dense_p = T.band_to_dense(T.pad_band_to(band, 96, 7).double()).numpy()
    dense = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(dense_p[:60, :60], dense)
    np.testing.assert_array_equal(dense_p[60:, :60], 0.0)
    np.testing.assert_array_equal(dense_p[:60, 60:], 0.0)
    np.testing.assert_array_equal(dense_p[60:, 60:], np.eye(36))
    xp = np.linalg.solve(dense_p, T.pad_rhs_to(b, 96).double().numpy())
    np.testing.assert_allclose(xp[:60], np.linalg.solve(dense, b.astype(np.float64)),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(xp[60:], 0.0)


def test_k_padded_band_is_permuted_blkdiag():
    """When the bucket widens K, the padded dense matrix is a symmetric
    permutation of blkdiag(A, I): no structurally singular outer diagonal."""
    n, k, nb, kb = 60, 3, 128, 4
    band, _, _ = _system(n, k, seed=5)
    perm = T.pad_permutation(n, k, nb, kb)
    dense_p = T.band_to_dense(T.pad_band_to(band, nb, kb).double()).numpy()
    blk = np.eye(nb)
    blk[:n, :n] = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    p_mat = np.zeros((nb, nb))
    p_mat[perm, np.arange(nb)] = 1.0
    np.testing.assert_array_equal(dense_p, p_mat @ blk @ p_mat.T)


@pytest.mark.parametrize("gen,d", [("random", 1.2), ("oscillatory", 0.5)])
@pytest.mark.parametrize("n,k,seed", [(96, 3, 0), (130, 6, 1), (200, 5, 2)])
def test_k_and_n_rounded_embedding_is_algebraically_exact(gen, d, n, k, seed):
    """The padded system's exact solution restricts to the unpadded
    system's (float64 linear algebra: a statement about the embedding)."""
    band = _band(gen, n, k, d, seed)
    nb, kb, _ = T.bucket_shape(n, k, 4, "pow2")
    assert nb > n and kb > k
    dense = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    dense_p = T.band_to_dense(T.pad_band_to(band, nb, kb).double()).numpy()
    b = np.random.default_rng(seed + 7).normal(size=n)
    perm = T.pad_permutation(n, k, nb, kb)
    bp = np.zeros(nb)
    bp[perm[:n]] = b
    xp = np.linalg.solve(dense_p, bp)
    np.testing.assert_allclose(xp[perm[:n]], np.linalg.solve(dense, b), rtol=1e-9, atol=1e-9)
    mask = np.ones(nb, bool)
    mask[perm[:n]] = False
    np.testing.assert_array_equal(xp[mask], 0.0)


def test_effective_bandwidth_matches_jax():
    band3 = _band("random", 50, 3, 1.2, seed=1)
    wide = np.zeros((50, 11), np.float32)
    wide[:, 2:9] = band3
    for band in (band3, wide):
        assert T.band_effective_k(band) == J.band_effective_k(band)
        np.testing.assert_array_equal(T.trim_band_to_effective(band),
                                      np.asarray(J.trim_band_to_effective(band)))
    assert T.band_effective_k(torch.tensor(wide)) == 3


def test_gj_inverse_identity_on_structurally_zero_rows():
    """A block whose trailing rows and columns are structurally zero
    inverts to the live block's inverse plus identity slots."""
    rng = np.random.default_rng(3)
    live = rng.normal(size=(3, 3))
    blk = np.zeros((5, 5))
    blk[:3, :3] = live
    inv = T.gj_inverse(torch.tensor(blk, dtype=torch.float32), boost_eps=1e-10).numpy()
    np.testing.assert_allclose(inv[:3, :3], np.linalg.inv(live), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(inv[3:, :3], 0.0)
    np.testing.assert_array_equal(inv[:3, 3:], 0.0)
    np.testing.assert_array_equal(inv[3:, 3:], np.eye(2))


# ---------------------------------------------------------------------------
# the stacked band operations
# ---------------------------------------------------------------------------


def test_stacked_band_ops_equal_per_system():
    bands = torch.stack([torch.tensor(_system(96, 3, seed=s)[0]) for s in range(3)])
    x = torch.randn(3, 96, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    y = T.band_matvec(bands, x)
    ym = T.band_matvec(bands, x[..., None].expand(-1, -1, 2))
    d = T.diag_dominance_factor(bands)
    bt = T.band_to_block_tridiag(bands, 3, 4)
    assert y.shape == (3, 96) and ym.shape == (3, 96, 2) and d.shape == (3,)
    for s in range(3):
        torch.testing.assert_close(y[s], T.band_matvec(bands[s], x[s]), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(ym[s, :, 1], y[s], rtol=1e-12, atol=1e-12)
        assert float(d[s]) == float(T.diag_dominance_factor(bands[s]))
        one = T.band_to_block_tridiag(bands[s], 3, 4)
        for name in ("d", "e", "f", "b_cpl", "c_cpl"):
            torch.testing.assert_close(getattr(bt, name)[s], getattr(one, name), rtol=0, atol=0)
    assert (bt.p, bt.m, bt.k) == (one.p, one.m, one.k)


# ---------------------------------------------------------------------------
# the batched lifecycle against the JAX batch
# ---------------------------------------------------------------------------

CASES = {
    # name: (variant, reduced_solver, generator, d, p, resolved reduced solver)
    "D": ("D", "auto", "random", 1.0, 4, "none"),
    "C": ("C", "auto", "random", 1.0, 4, "none"),
    "E_chain": ("E", "chain", "random", 1.0, 4, "chain"),
    "E_bcr": ("E", "auto", "random", 0.5, 16, "bcr"),
}


def _opts(mod, case, **kw):
    variant, reduced, _, _, p, _ = CASES[case]
    return mod.SaPOptions(p=p, variant=variant, reduced_solver=reduced, tol=TOL, maxiter=300, **kw)


@functools.lru_cache(maxsize=None)
def _batch(case):
    """Both packages' batches of the same four systems (N=320, K=5: the
    bucket widens K to 8, interleaved) and their solve_batch results."""
    _, _, gen, d, _, _ = CASES[case]
    systems = [_system(320, 5, d=d, seed=i, gen=gen) for i in range(4)]
    jpl = J.batch_plan([s[0] for s in systems], _opts(J, case))
    tpl = T.batch_plan([s[0] for s in systems], _opts(T, case), device="cpu")
    jfac, tfac = J.batch_factor(jpl), T.batch_factor(tpl)
    bmat = np.stack([np.asarray(J.pad_rhs_to(s[2], jpl.n)) for s in systems])
    return systems, jfac, tfac, bmat


@pytest.mark.parametrize("case", CASES)
def test_solve_batch_matches_jax(case):
    systems, jfac, tfac, bmat = _batch(case)
    assert (tfac.s, tfac.n, tfac.k) == (jfac.s, jfac.n, jfac.k) == (4, 512, 8)
    assert tfac.variant == jfac.variant == CASES[case][0]
    assert tfac.fac.pc.reduced_solver == CASES[case][5]
    jres = jfac.solve_batch(jnp.asarray(bmat))
    tres = tfac.solve_batch(torch.tensor(bmat))
    assert tres.x.shape == (4, 512) and tres.iterations.shape == (4,)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    assert bool(tres.converged.all())
    assert tres.true_resnorm.numpy().max() <= 10 * TOL
    assert np.asarray(jres.true_resnorm).max() <= 10 * TOL
    tx = T.unpad_solution(tres.x, tfac.orig_ns)
    jx = J.unpad_solution(jres.x, jfac.orig_ns)
    for (band, _, b), got, want in zip(systems, tx, jx):
        _close_x(got, want)
        assert _true_res(band, got, b) <= 10 * TOL


@pytest.mark.parametrize("case", CASES)
def test_solve_batch_many_matches_jax(case):
    _, jfac, tfac, _ = _batch(case)
    bmany = np.random.default_rng(9).normal(size=(4, tfac.n, 2)).astype(np.float32)
    jres = jfac.solve_batch_many(jnp.asarray(bmany))
    tres = tfac.solve_batch_many(torch.tensor(bmany))
    assert tres.x.shape == (4, tfac.n, 2) and tres.iterations.shape == (4, 2)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    for s in range(4):
        _close_x(tres.x[s].numpy(), np.asarray(jres.x[s]))
    assert tres.true_resnorm.numpy().max() <= 10 * TOL
    # column j of the many-RHS solve is the single-RHS batch solve of column
    # j (its float32 applies at R=1 round differently, so an exit may move)
    col = tfac.solve_batch(torch.tensor(bmany[:, :, 1]))
    assert col.true_resnorm.numpy().max() <= 10 * TOL
    for s in range(4):
        _close_x(tres.x[s, :, 1].numpy(), col.x[s].numpy())


@pytest.mark.parametrize("case", CASES)
def test_batch_equals_single_system_solves(case):
    """Each system of the batch solves as its own index_factorization does:
    the stacked layout changes nothing but the launch count."""
    _, _, tfac, bmat = _batch(case)
    res = tfac.solve_batch(torch.tensor(bmat))
    for s in range(4):
        one = T.index_factorization(tfac, s).solve(torch.tensor(bmat[s]))
        assert float(one.iterations) == float(res.iterations[s])
        _close_x(one.x.numpy(), res.x[s].numpy())


def test_history_and_d_factor_per_system():
    _, jfac, tfac, bmat = _batch("C")
    res = tfac.solve_batch(torch.tensor(bmat), record_history=True)
    jres = jfac.solve_batch(jnp.asarray(bmat), record_history=True)
    assert res.history.shape == np.asarray(jres.history).shape == (4, 300)
    assert res.d_factor.shape == (4,)
    np.testing.assert_allclose(res.d_factor.numpy(), np.asarray(jres.d_factor), rtol=1e-6)


def test_heterogeneous_nk_batch_matches_jax_and_unpadded_solves():
    """Systems of different (N, K) share one bucket; each padded solve
    agrees with the JAX batch and with its standalone unpadded solve."""
    opts = dict(p=4, variant="C", tol=1e-8, maxiter=400)
    systems = [_system(200, 3, seed=0), _system(301, 5, seed=1), _system(256, 4, seed=2)]
    jpl = J.batch_plan([s[0] for s in systems], J.SaPOptions(**opts))
    tpl = T.batch_plan([s[0] for s in systems], T.SaPOptions(**opts), device="cpu")
    assert tpl.orig_ns == jpl.orig_ns == (200, 301, 256)
    assert tpl.orig_ks == jpl.orig_ks == (3, 5, 4)
    assert (tpl.n, tpl.k) == (jpl.n, jpl.k)
    np.testing.assert_array_equal(tpl.bands.numpy(), np.asarray(jpl.bands))
    jfac, tfac = J.batch_factor(jpl), T.batch_factor(tpl)
    bmat = np.stack([np.asarray(J.pad_rhs_to(s[2], tpl.n)) for s in systems])
    jres, tres = jfac.solve_batch(jnp.asarray(bmat)), tfac.solve_batch(torch.tensor(bmat))
    # tol = 1e-8 is below what float32 iterations reach reliably: one sweep
    np.testing.assert_allclose(tres.iterations.numpy(), np.asarray(jres.iterations), atol=1.0)
    tx = T.unpad_solution(tres.x, tpl.orig_ns)
    for (band, xstar, b), x, jx in zip(systems, tx, J.unpad_solution(jres.x, jpl.orig_ns)):
        assert x.shape == xstar.shape
        _close_x(x, jx)
        solo = T.factor(T.plan_banded(band, T.SaPOptions(**opts), device="cpu")).solve(b)
        _close_x(x, solo.x.numpy(), tol=2e-4)


def test_bucket_of_size_one():
    band, xstar, b = _system(320, 5)
    opts = T.SaPOptions(p=4, tol=1e-6, maxiter=300)
    bfac = T.batch_factor(T.batch_plan([band], opts, device="cpu"))
    assert bfac.s == 1
    res = bfac.solve_batch(T.pad_rhs_to(b, bfac.n)[None])
    assert bool(res.converged.all())
    (x,) = T.unpad_solution(res.x, bfac.orig_ns)
    assert np.linalg.norm(x - xstar) / np.linalg.norm(xstar) < 1e-3


@pytest.mark.parametrize("members,want", [(("dominant",), "C"), (("dominant", "hard"), "E")])
def test_auto_variant_resolves_from_worst_system(members, want):
    pool = {"dominant": _band("random", 256, 4, 1.5, seed=0),
            "hard": _band("oscillatory", 256, 4, 0.5, seed=1)}
    bands = [pool[m] for m in members]
    opts = dict(p=4, variant="auto", tol=1e-5, maxiter=100)
    tfac = T.batch_factor(T.batch_plan(bands, T.SaPOptions(**opts), device="cpu"))
    jfac = J.batch_factor(J.batch_plan(bands, J.SaPOptions(**opts)))
    assert tfac.variant == jfac.variant == want


def test_index_stack_round_trip():
    _, _, tfac, bmat = _batch("E_bcr")
    facs = [T.index_factorization(tfac, i) for i in range(tfac.s)]
    assert facs[1].pc.red_bcr.root_inv.shape == tfac.fac.pc.red_bcr.root_inv.shape[1:]
    again = T.stack_factorizations(facs, tfac.orig_ns)
    assert again.s == tfac.s and again.orig_ns == tfac.orig_ns and again.variant == "E"
    levels = zip(again.fac.pc.red_bcr.levels, tfac.fac.pc.red_bcr.levels)
    for got, want in [(a, b) for la, lb in levels for a, b in zip(la, lb)] + [
            (again.fac.pc.lu.sinv, tfac.fac.pc.lu.sinv), (again.fac.x_perm, tfac.fac.x_perm),
            (again.fac.op.band, tfac.fac.op.band), (again.fac.d_factor, tfac.fac.d_factor)]:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    r1 = tfac.solve_batch(torch.tensor(bmat))
    r2 = again.solve_batch(torch.tensor(bmat))
    torch.testing.assert_close(r1.x, r2.x, rtol=0, atol=0)


def test_stack_factorizations_rejects_mixed_buckets_and_variants():
    opts = T.SaPOptions(p=4)
    f1 = T.factor(T.plan_banded(_system(256, 4)[0], opts, device="cpu"))
    f2 = T.factor(T.plan_banded(_system(128, 4)[0], opts, device="cpu"))
    with pytest.raises(ValueError, match="different buckets"):
        T.stack_factorizations([f1, f2])
    f3 = T.factor(T.plan_banded(_system(256, 4)[0], T.SaPOptions(p=4, variant="E"), device="cpu"))
    with pytest.raises(ValueError, match="different buckets/variants"):
        T.stack_factorizations([f1, f3])
    with pytest.raises(ValueError, match="at least one"):
        T.stack_factorizations([])
    both = T.stack_factorizations([f1, f1])
    assert both.s == 2 and both.fac.pc.lu.sinv.shape[0] == 2


def test_solve_batch_shape_errors():
    band, _, b = _system(320, 5)
    bfac = T.batch_factor(T.batch_plan([band], T.SaPOptions(p=4), device="cpu"))
    with pytest.raises(ValueError, match="one RHS per system"):
        bfac.solve_batch(T.pad_rhs_to(b, bfac.n))  # missing system axis
    with pytest.raises(ValueError, match="solve_batch_many"):
        bfac.solve_batch_many(T.pad_rhs_to(b, bfac.n)[None])


def test_batch_plan_accepts_stacked_array_and_needs_a_card_by_default(monkeypatch):
    bands = np.stack([_system(256, 4, seed=i)[0] for i in range(3)])
    bpl = T.batch_plan(bands, T.SaPOptions(p=4), device="cpu")
    assert bpl.s == 3 and bpl.orig_ns == (256, 256, 256) and bpl.bands.device.type == "cpu"
    assert T.batch_factor(bpl).s == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.batch_plan(bands, T.SaPOptions(p=4))


# ---------------------------------------------------------------------------
# misconvergence: the batched solve through a K-rounding bucket
# ---------------------------------------------------------------------------


def test_oscillatory_k3_pow2_bucket_variant_e_converges_truly():
    """Oscillatory d < 1 band, K=3 bucketed to 4, variant E: converged with
    a true residual at most tol, as the JAX batch."""
    tol = 1e-5
    band = _band("oscillatory", 128, 3, 0.5, seed=0)
    b = np.float32(np.random.default_rng(1).normal(size=128))
    opts = dict(p=4, variant="E", tol=tol, maxiter=400)
    bpl = T.batch_plan([band], T.SaPOptions(**opts), device="cpu")
    assert bpl.k == 4 and bpl.orig_ks == (3,)
    res = T.batch_factor(bpl).solve_batch(T.pad_rhs_to(b, bpl.n)[None])
    assert bool(res.converged.all())
    (x,) = T.unpad_solution(res.x, bpl.orig_ns)
    assert _true_res(band, x, b) <= tol and float(res.true_resnorm[0]) <= tol
    jpl = J.batch_plan([band], J.SaPOptions(**opts))
    jres = J.batch_factor(jpl).solve_batch(J.pad_rhs_to(jnp.asarray(b), jpl.n)[None])
    assert float(res.iterations[0]) == float(jres.iterations[0])
    _close_x(x, J.unpad_solution(jres.x, jpl.orig_ns)[0])


@pytest.mark.parametrize("variant", ["C", "D", "E"])
def test_solver_matches_unpadded_through_k_rounding(variant):
    """The batched solve through a K-rounding bucket agrees with the
    standalone unpadded solve of each system."""
    opts = T.SaPOptions(p=4, variant=variant, tol=1e-6, maxiter=400)
    bands = [_band("random", 96, 3, 1.2, s) for s in range(3)]
    rng = np.random.default_rng(11)
    bs = [np.float32(rng.normal(size=96)) for _ in bands]
    bpl = T.batch_plan(bands, opts, device="cpu")
    assert bpl.k > 3
    res = T.batch_factor(bpl).solve_batch(torch.stack([T.pad_rhs_to(b, bpl.n) for b in bs]))
    assert bool(res.converged.all())
    for band, b, x in zip(bands, bs, T.unpad_solution(res.x, bpl.orig_ns)):
        solo = T.factor(T.plan_banded(band, opts, device="cpu")).solve(b)
        assert _true_res(band, x, b) < 100 * 1e-6
        np.testing.assert_allclose(x, solo.x.numpy(), rtol=1e-3, atol=1e-4)
