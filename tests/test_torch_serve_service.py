"""The port's AsyncSolverService and metrics registry against the JAX
package's, on the CPU.

Deterministic scenarios (``start=False`` and ``drain_once``) run through
both services with the same requests; their futures, outcomes and
counters must agree: which requests were shed or cancelled and why, which
variant each dominance class solved with, when the thrash guard widened
the rounding, and ``MetricsRegistry.to_prometheus()`` text equal to the
JAX registry's for the same updates.  Solutions agree within a normwise
relative difference of 1e-4 of the JAX ``x`` (float32 iterations), with
equal iteration counts -- but the ill-conditioned oscillatory d = 0.5
system, whose float32 exit moves, within one sweep and held by its
residual.  The threaded cases (drain thread, backpressure, a concurrent
soak) run on the port alone: every future must resolve.

The port's registry has no ``recompiles`` / ``compile_seconds`` counters
(XLA compiles have no counterpart here).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro.serve as JS
import repro_torch.core as T
import repro_torch.serve as TS
from repro.core.banded import band_matvec as jax_matvec
from repro.core.banded import oscillatory_banded, random_banded
from repro_torch.serve.metrics import Counter, Histogram


def _mat(n, k, seed, d=1.1):
    return np.float32(random_banded(n, k, d=d, seed=seed))


def _rhs_for(band, seed):
    x = np.random.default_rng(seed).normal(size=band.shape[0])
    return x, np.asarray(jax_matvec(jnp.asarray(band), jnp.asarray(x, jnp.float32)))


def _opts(mod, **kw):
    kw.setdefault("p", 4)
    kw.setdefault("variant", "C")
    kw.setdefault("tol", 1e-6)
    kw.setdefault("maxiter", 300)
    return mod.SaPOptions(**kw)


def _service(start=False, **kw):
    kw.setdefault("max_batch", 8)
    opts = kw.pop("opts", {})
    return TS.AsyncSolverService(_opts(T, **opts), start=start, device="cpu", **kw)


def _pair(**kw):
    """The JAX and the port service, both without a drain thread."""
    kw.setdefault("max_batch", 8)
    opts = kw.pop("opts", {})
    return (JS.AsyncSolverService(_opts(J, **opts), start=False, **kw),
            TS.AsyncSolverService(_opts(T, **opts), start=False, device="cpu", **kw))


def _outcomes(futs):
    return [f.outcome(timeout=0) for f in futs]


def _same(jouts, touts):
    for j, t in zip(jouts, touts):
        assert type(t).__name__ == type(j).__name__
        if isinstance(t, TS.Cancelled):
            assert t.reason == j.reason
        else:
            assert (t.variant, t.bucket, t.cache_hit, t.converged, t.iterations) == (
                j.variant, j.bucket, j.cache_hit, j.converged, j.iterations)
            assert np.linalg.norm(t.x - j.x) <= 1e-4 * np.linalg.norm(j.x)


def _counters(svc, drop=()):
    c = svc.snapshot()["counters"]
    return {k: v for k, v in c.items() if k not in drop}


JAX_ONLY = ("recompiles", "compile_seconds")


# -- metrics -------------------------------------------------------------------


def _updates(reg):
    c = reg.counter("reqs")
    c.inc()
    c.inc(2.5)
    reg.counter("solved_total").inc(7)
    g = reg.gauge("depth 1")
    g.set(4)
    g.dec()
    g.set_max(2)
    reg.gauge("9lives").inc(3)
    h = reg.histogram("lat", bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    reg.histogram("wait").observe(0.003)


def test_prometheus_text_equals_the_jax_registry():
    treg, jreg = TS.MetricsRegistry(), JS.MetricsRegistry()
    _updates(treg)
    _updates(jreg)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.to_prometheus(prefix="sap_") == jreg.to_prometheus(prefix="sap_")
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    assert tsnap["counters"] == jsnap["counters"] and tsnap["gauges"] == jsnap["gauges"]
    assert tsnap["histograms"]["lat"]["buckets"] == jsnap["histograms"]["lat"]["buckets"]
    assert treg.histogram("lat").quantile(0.5) == 1.0  # upper edge of the median's bucket


def test_metrics_registry_rules():
    reg = TS.MetricsRegistry()
    c = reg.counter("reqs")
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("reqs") is c
    with pytest.raises(ValueError):
        reg.gauge("reqs")  # a name of another type
    reg.histogram("lat", bounds=(0.1, 1.0))
    with pytest.raises(ValueError):
        reg.histogram("lat", bounds=(1.0, 2.0))
    assert np.isnan(Histogram("empty").quantile(0.5))


def test_metrics_thread_safety():
    c = Counter("c")
    h = Histogram("h", bounds=(0.5,))

    def spin():
        for _ in range(1000):
            c.inc()
            h.observe(0.25)

    threads = [threading.Thread(target=spin) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8000 and h.count == 8000 and h.sum == pytest.approx(2000.0)


# -- deterministic scenarios through both services ------------------------------


def test_deadlines_cancels_and_priorities_match_the_jax_service():
    """One stream: a zero deadline (shed), a client cancel, and priority /
    EDF order across two buckets with max_batch=1."""
    jsvc, tsvc = _pair(max_batch=1)
    small, big = _mat(100, 3, seed=1), _mat(600, 3, seed=2)
    _, bs = _rhs_for(small, seed=0)
    _, bb = _rhs_for(big, seed=0)
    futs = {}
    for name, svc in (("jax", jsvc), ("port", tsvc)):
        f = [svc.submit(small, bs, priority=0),
             svc.submit(big, bb, priority=5, deadline_s=600.0),
             svc.submit(big, bb, priority=5, deadline_s=60.0),
             svc.submit(small, bs, deadline_s=0.0),
             svc.submit(small, bs, priority=9)]
        f[4].cancel()
        futs[name] = f
    time.sleep(0.002)  # the zero deadline lapses
    order = {"jax": [], "port": []}
    for name, svc in (("jax", jsvc), ("port", tsvc)):
        while svc.pending:
            svc.drain_once()
            order[name].append([i for i, f in enumerate(futs[name]) if f.done()])
    assert order["port"] == order["jax"]
    assert order["port"][0] == [2, 3, 4]  # shed + cancelled, then the soonest deadline
    touts = _outcomes(futs["port"])
    _same(_outcomes(futs["jax"]), touts)
    assert touts[3] == TS.Cancelled("deadline") and touts[4] == TS.Cancelled("client")
    with pytest.raises(TS.SolveCancelled, match="deadline"):
        futs["port"][3].result(timeout=0)
    assert _counters(tsvc) == _counters(jsvc, JAX_ONLY)
    assert tsvc.engine.stats_snapshot()["solved"] == 3  # no wasted batch slot
    for svc in (jsvc, tsvc):
        svc.close()


def test_dominance_classes_route_as_the_jax_service():
    jsvc, tsvc = _pair(opts=dict(variant="auto", maxiter=400))
    dom = _mat(128, 3, seed=0, d=1.5)
    osc = np.float32(oscillatory_banded(128, 3, d=0.5, seed=1))
    _, bd = _rhs_for(dom, seed=0)
    _, bo = _rhs_for(osc, seed=1)
    outs = {}
    for name, svc in (("jax", jsvc), ("port", tsvc)):
        f = [svc.submit(dom, bd), svc.submit(osc, bo)]
        svc.drain_once()
        svc.drain_once()
        outs[name] = _outcomes(f)
    rd, ro = outs["port"]
    assert (rd.variant, ro.variant) == ("C", "E") and rd.converged and ro.converged
    assert not ro.misconverged
    assert rd.iterations == outs["jax"][0].iterations
    # the oscillatory d = 0.5 system is ill-conditioned: float32 rounding
    # moves its exit, so within one sweep, and it is held by its residual
    assert abs(ro.iterations - outs["jax"][1].iterations) <= 1.0
    res = np.asarray(jax_matvec(jnp.asarray(osc), jnp.asarray(ro.x, jnp.float32))) - bo
    assert np.linalg.norm(res) / np.linalg.norm(bo) < 1e-3  # ill-conditioned: the residual
    assert _counters(tsvc) == _counters(jsvc, JAX_ONLY)
    for svc in (jsvc, tsvc):
        svc.close()


def test_thrash_guard_widens_rounding_as_the_jax_service():
    kw = dict(rounding="exact", cache_size=1, thrash_window=4, thrash_ratio=0.25)
    jsvc, tsvc = _pair(**kw)
    for svc in (jsvc, tsvc):
        for i in range(6):
            band = _mat(96 + 4 * i, 3, seed=i)
            svc.submit(band, _rhs_for(band, seed=i)[1])
        while svc.pending:
            svc.drain_once()
    assert tsvc.rounding == jsvc.rounding == "pow2"
    band = _mat(97, 3, seed=99)
    b = _rhs_for(band, seed=99)[1]
    fj, ft = jsvc.submit(band, b), tsvc.submit(band, b)
    jsvc.drain_once()
    tsvc.drain_once()
    assert ft.result(timeout=0).bucket == fj.result(timeout=0).bucket == (256, 4, 4)
    assert _counters(tsvc) == _counters(jsvc, JAX_ONLY)
    assert tsvc.metrics.counter("rounding_widenings").value == 1
    for svc in (jsvc, tsvc):
        svc.close()


def test_misconvergence_counters_as_the_jax_service():
    n, seed = 128, 2
    band3 = np.float32(oscillatory_banded(n, 3, d=0.5, seed=seed))
    wide = np.zeros((n, 9), np.float32)
    wide[:, 1:8] = band3
    x = np.random.default_rng(seed + 10).normal(size=n)
    b = np.float32(T.band_to_dense(T.pad_band_to(band3, n, 3).double()).numpy() @ x)
    jsvc, tsvc = _pair(opts=dict(variant="E", tol=1e-5, maxiter=400), rounding="pow2")
    outs = []
    for svc in (jsvc, tsvc):
        fut = svc.submit(wide, b)
        svc.drain_once()
        outs.append(fut.result(timeout=0))
    assert outs[1].escalated and outs[1].converged and outs[0].escalated
    snap = tsvc.snapshot()
    assert snap["counters"]["misconverged_total"] >= 1 and snap["counters"]["escalations"] >= 1
    assert _counters(tsvc) == _counters(jsvc, JAX_ONLY)
    text = tsvc.render()
    assert "misconverged_total_total" not in text and "misconverged_total " in text
    assert "recompiles" not in text and "peak_device_bytes 0" in text
    for svc in (jsvc, tsvc):
        svc.close()


# -- futures, admission control and lifecycle -----------------------------------


def test_futures_resolve_through_the_drain_thread():
    svc = _service(start=True)
    try:
        futs, truth = [], []
        for i in range(5):
            band = _mat(150 + 37 * i, 3 + i % 2, seed=i)
            x, b = _rhs_for(band, seed=50 + i)
            futs.append(svc.submit(band, b))
            truth.append(x)
        for fut, x in zip(futs, truth):
            out = fut.result(timeout=180)
            assert fut.done() and not fut.cancelled() and out.converged
            assert isinstance(out.x, np.ndarray) and out.x.shape == x.shape
            assert np.linalg.norm(out.x - x) / np.linalg.norm(x) < 1e-3
    finally:
        svc.close()
    assert svc.metrics.counter("solved").value == 5
    assert svc.snapshot()["derived"]["solves_per_second"] > 0


def test_future_timeout_then_resolution_and_default_deadline():
    svc = _service()
    band = _mat(100, 3, seed=0)
    fut = svc.submit(band, _rhs_for(band, seed=0)[1])
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    assert not fut.done() and svc.drain_once() == 1
    assert fut.result(timeout=0).converged
    svc.close()
    svc = _service(default_deadline_s=0.0)
    fut = svc.submit(band, _rhs_for(band, seed=0)[1])
    time.sleep(0.002)
    svc.drain_once()
    assert fut.cancelled() and fut.outcome() == TS.Cancelled("deadline")
    svc.close()


def test_queue_full_and_close_without_drain():
    svc = _service(queue_cap=2)
    band = _mat(100, 3, seed=0)
    _, b = _rhs_for(band, seed=0)
    futs = [svc.submit(band, b, block=False) for _ in range(2)]
    with pytest.raises(TS.QueueFull):
        svc.submit(band, b, block=False)
    with pytest.raises(TS.QueueFull):  # blocking with a timeout also bounds
        svc.submit(band, b, timeout=0.02)
    assert svc.metrics.counter("queue_rejections").value == 2
    svc.close(drain=False)
    assert all(f.outcome(timeout=0) == TS.Cancelled("shutdown") for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(band, b)


def test_backpressure_unblocks_when_drained():
    svc = _service(start=True, queue_cap=2)
    band = _mat(100, 3, seed=0)
    _, b = _rhs_for(band, seed=0)
    futs = [svc.submit(band, b, timeout=180) for _ in range(6)]
    assert all(f.result(timeout=180).converged for f in futs)
    svc.close()


def test_class_override_must_keep_p_and_cost_accounting_is_refused():
    """A class override that changes p is refused; ``cost_accounting`` no
    longer is (it reaches the engine; ``test_torch_cost.py`` holds it)."""
    with pytest.raises(ValueError, match="changes p"):
        TS.AsyncSolverService(_opts(T, p=4), class_overrides={"dom": _opts(T, p=8)},
                              start=False, device="cpu")
    costed = TS.AsyncSolverService(_opts(T), cost_accounting=True, start=False, device="cpu")
    assert costed.engine.cost_accounting
    costed.close()
    over = TS.default_class_overrides(_opts(T, variant="auto"))
    assert (over["dom"].variant, over["nondom"].variant, over["nondom"].reduced_solver) == (
        "C", "E", "bcr")


def test_soak_concurrent_mixed_priorities_and_deadlines():
    """Client threads with mixed priorities and deadlines: every future
    resolves -- solved or shed -- and the counters add up."""
    svc = TS.AsyncSolverService(_opts(T, variant="auto"), max_batch=8, queue_cap=64,
                                device="cpu")
    n_threads, per_thread = 4, 6
    futs_by_thread = [[] for _ in range(n_threads)]
    errors = []

    def client(tid):
        try:
            rng = np.random.default_rng(tid)
            for j in range(per_thread):
                i = tid * per_thread + j
                band = _mat(100 + 25 * (i % 4), 3, seed=i % 5)
                b = rng.normal(size=band.shape[0]).astype(np.float32)
                deadline = 0.0 if i % 7 == 3 else 120.0
                futs_by_thread[tid].append(
                    svc.submit(band, b, priority=i % 3, deadline_s=deadline, timeout=120))
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(tid,)) for tid in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive(), "client thread hung on submit"
    assert not errors
    solved = shed = 0
    for futs in futs_by_thread:
        for fut in futs:
            out = fut.outcome(timeout=180)
            if isinstance(out, TS.Cancelled):
                assert out.reason in ("deadline", "shutdown")
                shed += 1
            else:
                assert out.converged
                solved += 1
    assert solved + shed == n_threads * per_thread and solved > 0
    svc.close()
    snap = svc.snapshot()
    assert snap["counters"]["solved"] == solved
    assert snap["counters"]["deadline_misses"] == shed
    assert snap["histograms"]["time_in_queue_s"]["count"] == solved
    assert snap["histograms"]["queue_depth"]["count"] == solved + shed
    assert snap["engine"]["solved"] == solved


def test_band_dominance_routes_classes():
    dom = _mat(128, 3, seed=0, d=1.5)
    osc = np.float32(oscillatory_banded(128, 3, d=0.5, seed=0))
    assert TS.band_dominance(dom) >= 1.0 > TS.band_dominance(osc)
    eye = np.zeros((8, 7), np.float32)
    eye[:, 3] = 1.0
    assert TS.band_dominance(eye) == np.inf
