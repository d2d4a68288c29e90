"""The port's SolverEngine against the JAX package's, on the CPU.

The same request stream (seeded numpy bands, float32 right-hand sides)
goes through ``repro.serve.SolverEngine`` (jnp path) and through
``repro_torch.serve.SolverEngine(..., device="cpu")``:

* ``matrix_fingerprint`` and ``band_dominance``: equal;
* every outcome: the same bucket, variant, cache hit and iteration count,
  ``x`` within a normwise relative difference of 1e-4 of the JAX ``x``,
  ``true_resnorm`` at most 10 * tol (or escalated as the JAX engine
  escalates);
* the engine's counters (hits, misses, factored systems, evictions,
  steps, misconvergences, escalations): equal.

The port's stats leave out the JAX engine's compile counters
(``recompiles_total``, ``compile_seconds_total``: XLA compiles have no
counterpart here); ``cost_accounting`` is held in ``test_torch_cost.py``.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
import repro_torch.core as T
import repro_torch.serve as TS
from repro.core.banded import band_matvec as jax_matvec
from repro.core.banded import oscillatory_banded, random_banded
from repro_torch.core import batched as tbatched

TOL = 1e-6
COUNTERS = ("submitted", "solved", "steps", "cache_hits", "cache_misses", "factored_systems",
            "evictions", "misconverged", "escalations")


def _mat(n, k, seed, d=1.1):
    return np.float32(random_banded(n, k, d=d, seed=seed))


def _rhs_for(band, seed):
    x = np.random.default_rng(seed).normal(size=band.shape[0])
    return x, np.asarray(jax_matvec(jnp.asarray(band), jnp.asarray(x, jnp.float32)))


def _engines(variant="C", **kw):
    kw.setdefault("max_batch", 8)
    opts = dict(p=4, variant=variant, tol=TOL, maxiter=300)
    return (JS.SolverEngine(J.SaPOptions(**opts), **kw),
            TS.SolverEngine(T.SaPOptions(**opts), device="cpu", **kw))


def _engine(**kw):
    return _engines(**kw)[1]


def _same_outcomes(jdone, tdone):
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for jr, tr in zip(jdone, tdone):
        j, t = jr.result, tr.result
        assert (t.bucket, t.variant, t.cache_hit, t.escalated, t.converged) == (
            j.bucket, j.variant, j.cache_hit, j.escalated, j.converged)
        assert t.iterations == j.iterations
        assert t.x.shape == j.x.shape
        assert np.linalg.norm(t.x - j.x) <= 1e-4 * np.linalg.norm(j.x)


def _same_counters(jeng, teng):
    js, ts = jeng.stats_snapshot(), teng.stats_snapshot()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}


# -- host-side keys ------------------------------------------------------------


def test_fingerprint_and_dominance_equal_the_jax_package():
    a = _mat(64, 3, seed=0)
    b = a.copy()
    b[10, 1] += 1e-3
    osc = np.float32(oscillatory_banded(64, 3, d=0.5, seed=0))
    for band in (a, b, a.astype(np.float64), osc, a[:, 1:6]):
        assert TS.matrix_fingerprint(band) == JS.matrix_fingerprint(band)
        assert TS.band_dominance(band) == JS.band_dominance(band)
    assert TS.matrix_fingerprint(a) == TS.matrix_fingerprint(a.copy())
    assert TS.matrix_fingerprint(a) != TS.matrix_fingerprint(b)
    assert TS.matrix_fingerprint(a) != TS.matrix_fingerprint(a.astype(np.float64))
    # a tensor is hashed from its host bytes
    assert TS.matrix_fingerprint(torch.tensor(a)) == JS.matrix_fingerprint(a)
    assert TS.band_dominance(torch.tensor(a)) == JS.band_dominance(a)


# -- the same streams through both engines ------------------------------------


def test_heterogeneous_fleet_matches_jax_engine():
    jeng, teng = _engines()
    truth = {}
    for i in range(5):
        band = _mat(150 + 37 * i, 3 + i % 2, seed=i)
        x, b = _rhs_for(band, seed=50 + i)
        assert jeng.submit_system(band, b) == teng.submit_system(band, b)
        truth[i] = x
    jdone, tdone = jeng.run_until_drained(), teng.run_until_drained()
    _same_outcomes(jdone, tdone)
    _same_counters(jeng, teng)
    assert len(tdone) == 5 and teng.pending == 0
    for r in tdone:
        assert r.result.converged and r.result.true_resnorm <= 10 * TOL
        x = truth[r.rid]
        assert np.linalg.norm(r.result.x - x) / np.linalg.norm(x) < 1e-3


def test_cache_hits_misses_and_evictions_match_jax_engine():
    """Time steps re-solving two alternating matrices (fresh RHS each) with
    a cache of one, then a step of duplicates: the same hits, misses,
    evictions and solutions as the JAX engine."""
    jeng, teng = _engines(cache_size=1)
    m1, m2 = _mat(200, 4, seed=1), _mat(200, 4, seed=2)
    stream = [(m1, 0), (m1, 1), (m2, 2), (m1, 3)]
    jdone, tdone = [], []
    for band, seed in stream:
        _, b = _rhs_for(band, seed)
        jeng.submit_system(band, b)
        teng.submit_system(band, b)
        jdone += jeng.step()
        tdone += teng.step()
    for seed in range(3):  # three RHS of one matrix in one step
        _, b = _rhs_for(m2, 10 + seed)
        jeng.submit_system(m2, b)
        teng.submit_system(m2, b)
    jdone += jeng.step()
    tdone += teng.step()
    _same_outcomes(jdone, tdone)
    _same_counters(jeng, teng)
    assert [r.result.cache_hit for r in tdone] == [False, True, False, False, False, True, True]
    assert teng.stats["evictions"] == 3 and teng.cached_factorizations == 1


def test_factor_runs_once_for_repeated_fingerprints(monkeypatch):
    """Re-submitting the same matrix across steps factors it once; the
    duplicates of one step factor once too."""
    calls = {"batches": 0, "systems": 0}
    real = tbatched.batch_factor

    def counting(bpl):
        calls["batches"] += 1
        calls["systems"] += bpl.s
        return real(bpl)

    monkeypatch.setattr(tbatched, "batch_factor", counting)
    eng = _engine()
    band = _mat(200, 4, seed=7)
    for step in range(4):
        eng.submit_system(band, _rhs_for(band, seed=step)[1])
        (done,) = eng.step()
        assert done.result.converged and done.result.cache_hit == (step > 0)
    for i in range(3):
        eng.submit_system(band, _rhs_for(band, seed=10 + i)[1])
    assert len(eng.step()) == 3
    assert calls == {"batches": 1, "systems": 1}
    assert eng.stats["cache_hits"] == 6 and eng.stats["cache_misses"] == 1
    assert eng.cache_hit_rate == 6 / 7


def test_batch_larger_than_cache_survives_midstep_eviction():
    eng = _engine(max_batch=8, cache_size=1)
    truth = {}
    for i in range(3):
        band = _mat(200, 4, seed=20 + i)
        x, b = _rhs_for(band, seed=i)
        truth[eng.submit_system(band, b)] = x
    done = eng.step()
    assert len(done) == 3
    for r in done:
        assert r.result.converged
        assert np.linalg.norm(r.result.x - truth[r.rid]) / np.linalg.norm(truth[r.rid]) < 1e-3
    assert eng.cached_factorizations == 1 and eng.stats["evictions"] == 2


def test_one_bucket_per_step_as_the_jax_engine():
    jeng, teng = _engines(max_batch=2)
    bands = [_mat(100, 3, seed=i) for i in range(3)] + [_mat(600, 3, seed=9)]
    for band in bands:
        b = _rhs_for(band, seed=0)[1]
        jeng.submit_system(band, b)
        teng.submit_system(band, b)
    jfirst, tfirst = jeng.step(), teng.step()
    assert {r.result.bucket for r in tfirst} == {(256, 4, 4)} and len(tfirst) == 2
    _same_outcomes(jfirst + jeng.run_until_drained(), tfirst + teng.run_until_drained())
    _same_counters(jeng, teng)
    assert teng.stats["steps"] == 3


def test_sticky_auto_variant():
    eng = TS.SolverEngine(T.SaPOptions(p=4, variant="auto", tol=1e-5, maxiter=200),
                          max_batch=4, device="cpu")
    band = _mat(200, 4, seed=3, d=1.5)
    eng.submit_system(band, _rhs_for(band, seed=0)[1])
    (done,) = eng.step()
    assert done.result.converged and eng.opts.variant == "C"
    band2 = _mat(230, 4, seed=4, d=1.5)
    eng.submit_system(band2, _rhs_for(band2, seed=1)[1])
    (done2,) = eng.step()
    assert done2.result.converged and done2.result.variant == "C"


def test_step_on_empty_queue_and_leftover_warning():
    eng = _engine(max_batch=1)
    assert eng.step() == [] and eng.stats["steps"] == 0
    band = _mat(100, 3, seed=0)
    for i in range(3):
        eng.submit_system(band, _rhs_for(band, seed=i)[1])
    with pytest.warns(RuntimeWarning, match=r"2 request\(s\) still queued"):
        done = eng.run_until_drained(max_steps=1)
    assert len(done) == 1 and eng.pending == 2
    with pytest.raises(RuntimeError, match=r"1 request\(s\) still queued"):
        eng.run_until_drained(max_steps=1, on_leftover="raise")
    assert eng.run_until_drained() and eng.pending == 0


def test_solve_prepared_and_options_in_the_cache_key():
    eng = _engine(cache_size=8)
    band = _mat(150, 3, seed=0)
    x, b = _rhs_for(band, seed=0)
    bucket = T.bucket_shape(150, 3, 4, "pow2")
    assert eng.solve_prepared([], bucket) == []
    for variant in ("C", "E"):
        opts = T.SaPOptions(p=4, variant=variant, tol=TOL, maxiter=300)
        (done,) = eng.solve_prepared([TS.SolveRequest(rid=0, band=band, b=b)], bucket, opts=opts)
        assert done.result.converged and done.result.variant == variant
        assert done.result.bucket == bucket
        assert np.linalg.norm(done.result.x - x) / np.linalg.norm(x) < 1e-3
    assert eng.cached_factorizations == 2 and eng.stats["cache_misses"] == 2
    assert eng.pending == 0 and eng.stats["solved"] == 2


def test_concurrent_submit_and_step_thread_safe():
    eng = _engine(max_batch=4)
    mats = [_mat(100 + 10 * (i % 3), 3, seed=i % 4) for i in range(12)]

    def client(tid):
        rng = np.random.default_rng(tid)
        for i in range(4):
            band = mats[(tid * 4 + i) % len(mats)]
            eng.submit_system(band, np.float32(rng.normal(size=band.shape[0])))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    done = []
    deadline = time.monotonic() + 120
    while len(done) < 12 and time.monotonic() < deadline:
        done.extend(eng.step())
    for t in threads:
        t.join(timeout=60)
    assert len(done) == 12 and all(r.result.converged for r in done)
    assert eng.stats["solved"] == 12 and eng.pending == 0


def test_precomputed_fingerprint_respected_and_stats_keys():
    eng = _engine()
    band = _mat(100, 3, seed=0)
    req = TS.SolveRequest(rid=99, band=band, b=_rhs_for(band, seed=0)[1], fingerprint="custom")
    eng.submit(req)
    assert req.fingerprint == "custom"
    (done,) = eng.step()
    assert done.rid == 99 and done.result.converged
    snap = eng.stats_snapshot()
    assert "recompiles_total" not in snap and "compile_seconds_total" not in snap
    assert snap["peak_device_bytes"] == 0  # nothing lives on a card here
    assert eng.systems_per_second > 0
    costed = TS.SolverEngine(T.SaPOptions(p=4), cost_accounting=True, device="cpu")
    assert costed.cost_accounting and costed.cost_snapshot() == {}


# -- the misconvergence guard ---------------------------------------------------


def _wide_stored_oscillatory(n=128, k_true=3, k_stored=4, seed=1):
    """A K=3 matrix submitted in K=4 band storage (exactly-zero outer
    diagonals): K equals the bucket's K, so no interleave kicks in and the
    first pass misconverges."""
    band3 = np.float32(oscillatory_banded(n, k_true, d=0.5, seed=seed))
    wide = np.zeros((n, 2 * k_stored + 1), np.float32)
    pad = k_stored - k_true
    wide[:, pad : 2 * k_true + 1 + pad] = band3
    x = np.random.default_rng(seed + 10).normal(size=n)
    b = T.band_to_dense(torch.tensor(band3, dtype=torch.float64)).numpy() @ x
    return wide, np.float32(b)


@pytest.mark.parametrize("guard,escalates", [(None, True), (1e3, False)])
def test_guard_escalates_as_the_jax_engine(guard, escalates):
    """A converged-but-wrong first pass is detected and re-solved in an
    exact bucket (the default guard, 10 * tol); a huge explicit guard
    accepts the first pass.  Both engines agree on every counter."""
    tol = 1e-5
    wide, b = _wide_stored_oscillatory()
    opts = dict(p=4, variant="E", tol=tol, maxiter=400, check_true_residual=guard)
    jeng = JS.SolverEngine(J.SaPOptions(**opts), rounding="pow2")
    teng = TS.SolverEngine(T.SaPOptions(**opts), rounding="pow2", device="cpu")
    for eng in (jeng, teng):
        eng.submit_system(wide, b)
    (jdone,), (tdone,) = jeng.step(), teng.step()
    r = tdone.result
    assert r.escalated == jdone.result.escalated == escalates
    assert r.misconverged == jdone.result.misconverged == False  # noqa: E712
    _same_counters(jeng, teng)
    if escalates:
        assert r.converged and r.true_resnorm <= 10 * tol
        dense = T.band_to_dense(torch.tensor(wide, dtype=torch.float64)).numpy()
        assert np.linalg.norm(b - dense @ r.x) / np.linalg.norm(b) <= 10 * tol
        assert teng.stats["misconverged"] >= 1 and teng.stats["escalations"] >= 1
    else:
        assert teng.stats["escalations"] == 0


def test_true_resnorm_on_the_served_path():
    band = np.float32(random_banded(128, 3, d=1.2, seed=4))
    b = np.float32(np.random.default_rng(5).normal(size=128))
    eng = TS.SolverEngine(T.SaPOptions(p=4, variant="C", tol=TOL, maxiter=300), device="cpu")
    eng.submit_system(band, b)
    (done,) = eng.step()
    dense = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    want = np.linalg.norm(b - dense @ done.result.x) / np.linalg.norm(b)
    assert np.isfinite(done.result.true_resnorm) and done.result.true_resnorm < 1e-3
    assert abs(done.result.true_resnorm - want) < 1e-4


def test_float32_stall_at_tol_1e8_demotes_in_both_engines():
    """A small non-dominant request at tol = 1e-8 (N=200, K=3, d=0.5, P=4,
    "auto" -> E): the float32 preconditioner's stall (ROADMAP P2) leaves the
    true residual above the 10 * tol guard, so the first pass misconverges,
    the escalated pass too, and both engines demote ``converged``.  The
    same request on the card gave 4.5e-6 (``tests/test_torch_gpu.py``)."""
    band = np.float32(random_banded(200, 3, d=0.5, seed=8))
    x = np.random.default_rng(0).normal(size=200)
    b = T.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy() @ x
    opts = dict(p=4, variant="auto", tol=1e-8, maxiter=200)
    jeng = JS.SolverEngine(J.SaPOptions(**opts), max_batch=1)
    teng = TS.SolverEngine(T.SaPOptions(**opts), max_batch=1, device="cpu")
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        eng.submit_system(band, b)
        (done,) = eng.run_until_drained()
        out[name] = done.result
    j, t = out["jax"], out["port"]
    assert (t.bucket, t.variant, t.escalated) == (j.bucket, j.variant, j.escalated)
    assert (t.bucket, t.variant, t.escalated) == ((204, 3, 4), "E", True)
    assert not j.converged and not t.converged
    guard = 10 * 1e-8
    assert j.true_resnorm > guard and t.true_resnorm > guard
    assert max(j.true_resnorm, t.true_resnorm) <= 10 * min(j.true_resnorm, t.true_resnorm)
