"""The port's tracer against the JAX package's, on the CPU.

The cases of ``tests/test_obs.py`` that need no jax run on
``repro_torch.obs`` (nesting, the disabled tracer, ``use_tracer``,
per-thread stacks, ``record``, ``summary``, the Chrome events held by
``benchmarks/check_trace.py:validate_events``), then the spans the
lifecycle and the serving stack open: for the same call on the CPU, the
port's span tree (names and nesting, and each span's attribute names)
equals the JAX package's.  Two differences are stated and held:

* the batched factor: the port's ``factor.batch`` never has lifecycle
  children (its single-system stage spans are quiet inside it, standing
  for the JAX package's ``vmap``);
* the compile span: the JAX package's first ``factor.batch`` of a bucket
  holds a ``compile`` span (its ahead-of-time compile), the port's never;
* the port's own spans and attributes, which the trees are compared
  without (``_port_only``): the Krylov loop's ``krylov.*`` sub-spans,
  BCR's ``factor.reduced.level`` spans, the ``plan`` span of
  ``plan_banded`` (attribute ``banded``), and the ``launches`` attribute
  of the ``factor`` and ``krylov`` spans.  Their own cases, and the
  counters, clock and device-timed spans, are held below.

With jax 0.9 the JAX package's spans do not degrade while it traces
(``repro/obs/trace.py:_under_jax_trace`` reads a ``jax.core`` attribute
that is gone, so it answers False), and that first ``factor.batch`` also
holds the stage spans recorded while the factor stages were traced.  So
the batched, engine and service trees are compared on a warm bucket,
where the JAX package's ``factor.batch`` has no child, and the cold
bucket's difference is held in its own test.
"""

import json
import math
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro.serve as JS
import repro_torch.core as T
import repro_torch.serve as TS
from benchmarks.check_trace import validate_events
from benchmarks.common import stage_fractions
from repro.core import sparse as jsp
from repro.core.banded import random_banded
from repro.obs import Tracer as JaxTracer
from repro.obs import use_tracer as jax_use_tracer
from repro_torch.core import sparse as tsp
from repro_torch.obs import NULL_SPAN, Tracer, get_tracer, quiet, span, use_tracer
from repro_torch.obs import trace as trace_mod

TOL = 1e-6


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------


def test_span_nesting_and_attrs():
    tr = Tracer()
    with tr.span("outer", n=4) as sp:
        time.sleep(0.001)
        with tr.span("inner") as child:
            child.annotate(hits=2)
        sp.annotate(done=True)
    (root,) = tr.roots()
    assert root.name == "outer"
    assert root.attrs == {"n": 4, "done": True}
    assert [c.name for c in root.children] == ["inner"]
    assert root.children[0].attrs == {"hits": 2}
    assert root.duration_s >= 0.001
    assert root.duration_s >= root.children[0].duration_s
    assert tr.find("inner") and tr.durations()["outer"] == root.duration_s


def test_disabled_tracer_returns_null_span():
    tr = Tracer(enabled=False)
    sp = tr.span("x", a=1)
    assert sp is NULL_SPAN
    assert not sp  # falsy: guards `if sp: sp.annotate(...)` call sites
    with sp:
        assert sp.sync("v") == "v"
        sp.annotate(b=2)
    assert tr.roots() == []


def test_module_span_without_active_tracer_is_null():
    assert get_tracer() is None
    assert span("anything") is NULL_SPAN


def test_use_tracer_nests_and_restores():
    t1, t2 = Tracer(), Tracer()
    with use_tracer(t1):
        assert get_tracer() is t1
        with use_tracer(t2):
            assert get_tracer() is t2
            with span("on-t2"):
                pass
        assert get_tracer() is t1
    assert get_tracer() is None
    assert [s.name for s in t2.roots()] == ["on-t2"]
    assert t1.roots() == []


def test_thread_safety_per_thread_stacks():
    tr = Tracer()

    def worker(i):
        with tr.span(f"w{i}"):
            with tr.span("child"):
                time.sleep(0.001)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    roots = tr.roots()
    assert len(roots) == 8  # one root per thread, never cross-adopted
    assert {r.name for r in roots} == {f"w{i}" for i in range(8)}
    assert all(len(r.children) == 1 for r in roots)


def test_record_retroactive_span():
    tr = Tracer()
    t0 = tr.now()
    time.sleep(0.001)
    tr.record("request", t0, tr.now(), rid=7)
    (root,) = tr.roots()
    assert root.name == "request" and root.attrs["rid"] == 7
    assert root.duration_s >= 0.001


def test_summary_tree():
    tr = Tracer()
    with tr.span("solve"):
        with tr.span("factor"):
            pass
        with tr.span("krylov"):
            pass
    text = tr.summary()
    assert "solve" in text and "  factor" in text and "  krylov" in text
    assert "% parent" in text


def test_quiet_degrades_spans_on_its_thread_only():
    tr = Tracer()
    seen = []
    with use_tracer(tr):
        with span("outer"):
            with quiet():
                with quiet():
                    assert span("hidden") is NULL_SPAN
                assert span("still-hidden") is NULL_SPAN
                worker = threading.Thread(target=lambda: seen.append(span("other") is NULL_SPAN))
                worker.start()
                worker.join(timeout=30)
            with span("shown"):
                pass
    assert seen == [False]  # another thread is not quieted
    (root,) = tr.roots()
    assert [c.name for c in root.children] == ["shown"]


def test_capture_degrades_to_null_span(monkeypatch):
    monkeypatch.setattr(trace_mod, "_under_capture", lambda: True)
    assert Tracer().span("decode_step") is NULL_SPAN


def test_sync_waits_for_nothing_without_a_cuda_tensor():
    import torch

    tr = Tracer()
    x = torch.ones(3)
    with tr.span("cpu") as sp:
        assert sp.sync({"a": (x, [x])}) is not None
    assert trace_mod._cuda_devices({"a": (x, [x])}, set()) == set()
    assert tr.roots()[0].duration_s >= 0.0


def test_annotate_device_names_the_profiler_ranges():
    """``annotate_device`` opens a ``torch.profiler.record_function`` of the
    span's name, so spans line up with the kernels in a profile."""
    import torch

    tr = Tracer(annotate_device=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("factor.lu"):
            torch.ones(8) @ torch.ones(8)
    assert "factor.lu" in {e.key for e in prof.key_averages()}
    assert [s.name for s in tr.roots()] == ["factor.lu"]


def _traced_forest():
    tr = Tracer()
    with tr.span("a", nan=float("nan")):
        with tr.span("b"):
            pass
    # overlapping retroactive spans (the serve.request pattern); ns clock
    t = tr.now()
    tr.record("req", t - 10_000_000, t - 2_000_000)
    tr.record("req", t - 8_000_000, t - 1_000_000)
    return tr


def test_chrome_events_validate(tmp_path):
    tr = _traced_forest()
    pairs = validate_events(tr.to_chrome_events())
    assert pairs == {"a": 1, "b": 1, "req": 2}
    # NaN attrs must still produce strict JSON
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    doc = json.loads(Path(path).read_text())
    assert validate_events(doc["traceEvents"])
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"process_name", "thread_name"} <= names
    proc = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert proc[0]["args"]["name"] == "repro_torch.solve"


# ---------------------------------------------------------------------------
# span trees: the port's against the JAX package's
# ---------------------------------------------------------------------------


PORT_ONLY_ATTRS = ("launches",)


def _port_only(sp):
    """A span the port opens and the JAX package does not: the Krylov
    loop's sub-spans, BCR's levels, the plan span of ``plan_banded``."""
    return (sp.name.startswith("krylov.") or sp.name == "factor.reduced.level"
            or (sp.name == "plan" and bool(sp.attrs.get("banded"))))


def _tree(tracer):
    """(name, attribute names, children) for every root, children by start
    time, without the port's own spans and attributes."""
    def rec(sp):
        kids = sorted((c for c in sp.children if not _port_only(c)), key=lambda c: c.t0)
        attrs = tuple(sorted(a for a in sp.attrs if a not in PORT_ONLY_ATTRS))
        return (sp.name, attrs, tuple(rec(c) for c in kids))

    roots = (r for r in tracer.roots() if not _port_only(r))
    return tuple(rec(r) for r in sorted(roots, key=lambda s: s.t0))


def _names(tree):
    return tuple((name, _names(kids)) for name, _, kids in tree)


def _band(n=256, k=4, d=0.5, seed=0):
    return np.float32(random_banded(n, k, d=d, seed=seed))


def _rhs(n, seed=0):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _both(jax_fn, port_fn, warm=False):
    """Both calls under a tracer each; with ``warm``, each runs once
    untraced first (the JAX package compiles its batched factor stages
    for the bucket then)."""
    if warm:
        jax_fn()
        port_fn()
    jt, tt = JaxTracer(), Tracer()
    with jax_use_tracer(jt):
        jax_fn()
    with use_tracer(tt):
        port_fn()
    return jt, tt


LIFECYCLE = {
    "D": dict(variant="D"),
    "C": dict(variant="C"),
    "C_fused": dict(variant="C", fused_factor="on"),
    "E_chain": dict(variant="E", reduced_solver="chain"),
    "E_bcr": dict(variant="E", reduced_solver="bcr"),
}


@pytest.mark.parametrize("case", list(LIFECYCLE))
def test_lifecycle_span_tree_equals_jax(case):
    kw = dict(LIFECYCLE[case], p=4, tol=TOL, maxiter=300)
    band, b = _band(), _rhs(256)
    jt, tt = _both(
        lambda: J.factor(J.plan_banded(band, J.SaPOptions(**kw))).solve(b),
        lambda: T.factor(T.plan_banded(band, T.SaPOptions(**kw), device="cpu")).solve(b),
    )
    assert _tree(tt) == _tree(jt)
    stages = {"C_fused": "factor.fused", "D": "factor.lu"}.get(case, "factor.spike")
    assert tt.find(stages) and (case != "C_fused" or not tt.find("factor.lu"))
    (kr,) = tt.find("krylov")
    assert set(kr.attrs["convergence"]) == set(jt.find("krylov")[0].attrs["convergence"])


def test_solve_many_span_tree_equals_jax():
    kw = dict(p=4, variant="C", tol=TOL, maxiter=300)
    band = _band(d=1.1)
    bm = np.stack([_rhs(256, s) for s in range(3)], axis=1)
    jt, tt = _both(
        lambda: J.factor(J.plan_banded(band, J.SaPOptions(**kw))).solve_many(bm,
                                                                           record_history=True),
        lambda: T.factor(T.plan_banded(band, T.SaPOptions(**kw), device="cpu")).solve_many(
            bm, record_history=True),
    )
    assert _tree(tt) == _tree(jt)
    (jk,), (tk,) = jt.find("krylov"), tt.find("krylov")
    assert tk.attrs["nrhs"] == 3 and set(tk.attrs["convergence"]) == set(jk.attrs["convergence"])
    assert tk.attrs["convergence"]["recorded"] == jk.attrs["convergence"]["recorded"]


def test_sparse_plan_span_tree_equals_jax():
    csr = jsp.random_sparse(240, 8.0, d=1.0, seed=240, structured_band=6)
    tcsr = tsp.CSR(indptr=csr.indptr, indices=csr.indices, data=csr.data, n=csr.n)
    kw = dict(p=4, variant="C", tol=TOL, maxiter=300, drop_tol=0.01)
    b = np.ones(240, np.float32)
    jt, tt = _both(
        lambda: J.factor(J.plan(csr, J.SaPOptions(**kw))).solve(b),
        lambda: T.factor(T.plan(tcsr, T.SaPOptions(**kw), device="cpu")).solve(b),
    )
    assert _tree(tt) == _tree(jt)
    assert _names(_tree(tt))[0] == ("plan", (("reorder", (
        ("reorder.db", ()), ("reorder.cm", ()), ("reorder.drop", ()),
        ("reorder.assemble", ()))),))
    (rsp,) = tt.find("reorder")
    assert rsp.attrs["k"] == jt.find("reorder")[0].attrs["k"]


def _batch_calls(bands, kw):
    jpl = J.batch_plan(bands, J.SaPOptions(**kw))
    tpl = T.batch_plan(bands, T.SaPOptions(**kw), device="cpu")
    return (lambda: J.batch_factor(jpl).solve_batch(jnp.ones((jpl.s, jpl.n))),
            lambda: T.batch_factor(tpl).solve_batch(np.ones((tpl.s, tpl.n), np.float32)))


@pytest.mark.parametrize("variant", ["C", "E"])
def test_batched_span_tree_equals_jax_on_a_warm_bucket(variant):
    """``factor.batch`` has no lifecycle children in either package once the
    JAX package's factor stages are compiled for the bucket."""
    kw = dict(p=4, variant=variant, tol=TOL, maxiter=300)
    bands = [_band(200 + 24 * s, 3, d=1.1, seed=s) for s in range(3)]
    jt, tt = _both(*_batch_calls(bands, kw), warm=True)
    assert _tree(tt) == _tree(jt)
    assert _names(_tree(tt)) == (("factor.batch", ()), ("krylov", ()))


@pytest.mark.parametrize("variant", ["C", "E"])
def test_cold_bucket_compile_span_is_the_jax_package_s_alone(variant):
    """The two stated differences, on a bucket neither package has seen:
    the JAX package's first ``factor.batch`` holds a ``compile`` span (and,
    with jax 0.9, the stage spans recorded while it traced); the port's
    has no child and there is no ``compile`` span anywhere."""
    kw = dict(p=3, variant=variant, tol=TOL, maxiter=300)
    bands = [_band(333 + 7 * s + (variant == "E"), 3, d=1.1, seed=s) for s in range(2)]
    jt, tt = _both(*_batch_calls(bands, kw))
    (jfb,) = jt.find("factor.batch")
    kids = {c.name for c in jfb.children}
    assert "compile" in kids
    assert kids <= {"compile", "factor.lu", "factor.spike", "factor.fused", "factor.reduced"}
    assert _names(_tree(tt)) == (("factor.batch", ()), ("krylov", ()))
    assert tt.find("compile") == []
    # less the JAX package's children, the trees agree
    assert _names(_tree(tt)) == tuple(
        (name, () if name == "factor.batch" else kids_)
        for name, kids_ in _names(_tree(jt)))


def test_engine_span_tree_equals_jax_on_a_warm_bucket():
    opts = dict(p=4, variant="C", tol=TOL, maxiter=300)
    band = _band(d=1.1)
    jeng = JS.SolverEngine(J.SaPOptions(**opts), max_batch=4)
    teng = TS.SolverEngine(T.SaPOptions(**opts), max_batch=4, device="cpu")

    def drive(eng):
        for s in range(3):
            eng.submit_system(band, _rhs(256, s))
        eng.run_until_drained()

    # a first engine of each package warms the bucket (untraced)
    drive(JS.SolverEngine(J.SaPOptions(**opts), max_batch=4))
    drive(TS.SolverEngine(T.SaPOptions(**opts), max_batch=4, device="cpu"))
    jt, tt = _both(lambda: drive(jeng), lambda: drive(teng))
    assert _tree(tt) == _tree(jt)
    assert _names(_tree(tt)) == (("engine.solve_prepared", (("factor.batch", ()),
                                                             ("krylov", ()))),)
    (tsp_,), (jsp_,) = tt.find("engine.solve_prepared"), jt.find("engine.solve_prepared")
    for key in ("bucket", "batch", "escalated", "variant", "cache_hits", "cache_misses",
                "escalations"):
        assert tsp_.attrs[key] == jsp_.attrs[key], key


def test_service_span_tree_equals_jax_on_a_warm_bucket():
    opts = dict(p=4, variant="C", tol=TOL, maxiter=300)
    band = _band(d=1.1)

    def drive(svc):
        try:
            futs = [svc.submit(band, _rhs(256, s)) for s in range(3)]
            while svc.drain_once():
                pass
            assert all(f.result(timeout=5).converged for f in futs)
        finally:
            svc.close()

    jt, tt = _both(
        lambda: drive(JS.AsyncSolverService(J.SaPOptions(**opts), max_batch=4, start=False)),
        lambda: drive(TS.AsyncSolverService(T.SaPOptions(**opts), max_batch=4, start=False,
                                            device="cpu")),
        warm=True,
    )
    assert _tree(tt) == _tree(jt)
    assert _names(_tree(tt)) == (("serve.request", ()),) * 3 + (
        ("serve.dispatch", (("engine.solve_prepared", (("factor.batch", ()),
                                                       ("krylov", ()))),)),)


# ---------------------------------------------------------------------------
# the engine and the service on the active tracer
# ---------------------------------------------------------------------------


def test_engine_spans_and_stage_split():
    opts = T.SaPOptions(p=4, variant="C", tol=TOL)
    bands = [_band(d=1.1, seed=s) for s in (0, 1)]
    bmat = np.stack([_rhs(256, s) for s in (0, 1)])
    tr = Tracer()
    with use_tracer(tr):
        bfac = T.batch_factor(T.batch_plan(bands, opts, device="cpu"))
        bfac.solve_batch(bmat)
    names = {s.name for s in tr.walk()}
    assert {"factor.batch", "krylov"} <= names
    conv = tr.find("krylov")[0].attrs["convergence"]
    assert conv["converged"] is True and conv["iterations"] > 0
    stages = stage_fractions(tr)
    assert set(stages) == {"lu_spk", "krylov"}
    assert sum(stages.values()) == pytest.approx(1.0, abs=0.02)


def test_service_request_spans():
    svc = TS.AsyncSolverService(T.SaPOptions(p=4, variant="C", tol=TOL), max_batch=4,
                                start=False, device="cpu")
    try:
        band = _band(d=1.1)
        tr = Tracer()
        with use_tracer(tr):
            futs = [svc.submit(band, _rhs(256, s)) for s in range(3)]
            while svc.drain_once():
                pass
        assert all(f.result(timeout=1).converged for f in futs)
        # one dispatch span wrapping the engine span, plus one retroactive
        # serve.request root per request covering submit -> resolve
        (disp,) = tr.find("serve.dispatch")
        assert disp.attrs["batch"] == 3 and disp.attrs["dclass"] == "dom"
        assert [c.name for c in disp.children] == ["engine.solve_prepared"]
        reqs = tr.find("serve.request")
        assert len(reqs) == 3
        for sp in reqs:
            assert sp.duration_s >= disp.duration_s * 0.5
            assert "queue_s" in sp.attrs and "cache_hit" in sp.attrs
        # and the export of overlapping retroactive spans stays valid
        assert validate_events(tr.to_chrome_events())["serve.request"] == 3
    finally:
        svc.close()


def test_disabled_overhead_under_two_percent():
    """Null-span cost per solve_prepared call < 2% of the warm solve time."""
    from repro_torch.core.batched import bucket_shape
    from repro_torch.serve.solver_engine import SolveRequest

    eng = TS.SolverEngine(T.SaPOptions(p=4, variant="C", tol=TOL), max_batch=8, cache_size=16,
                          device="cpu")
    band = _band(d=1.1)
    bkt = bucket_shape(256, 4, 4, "pow2")

    def one_pass(seed):
        eng.solve_prepared([SolveRequest(rid=0, band=band, b=_rhs(256, seed))], bkt)

    one_pass(0)  # the factorization is cached from here on
    t0 = time.perf_counter()
    for s in range(5):
        one_pass(s + 1)
    warm_solve_s = (time.perf_counter() - t0) / 5

    # per-site cost of an instrumented span with tracing disabled
    with use_tracer(Tracer(enabled=False)):
        n = 10_000
        t0 = time.perf_counter()
        for _ in range(n):
            with span("engine.solve_prepared", bucket="256x4", batch=1):
                pass
        per_site_s = (time.perf_counter() - t0) / n
    # the hot path crosses a handful of span sites per solve; even 10x
    # that stays far under the 2% budget
    assert per_site_s * 10 < 0.02 * warm_solve_s, (
        f"null-span overhead {per_site_s * 1e9:.0f} ns/site vs warm solve "
        f"{warm_solve_s * 1e6:.0f} us"
    )


def _smoke():
    """``chip_smoke.py``, whose TRACE_TREES are the trees its phase "trace"
    holds the card's spans to, less the spans ``trace_port_only`` names
    (the script imports only the standard library at module level)."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_trees", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["C", "E_bcr", "sparse"])
def test_smoke_trace_trees_are_the_jax_package_s(case):
    """The card's fused factor ("auto" on the card) is ``fused_factor="on"``
    here; both packages' trees for the smoke's three traced calls are the
    list the smoke checks, and the smoke leaves out the spans the port's
    tree is compared without here."""
    kw = dict(p=4, tol=TOL, maxiter=300, fused_factor="on")
    if case == "sparse":
        csr = jsp.random_sparse(240, 8.0, d=1.0, seed=240, structured_band=6)
        tcsr = tsp.CSR(indptr=csr.indptr, indices=csr.indices, data=csr.data, n=csr.n)
        b = np.ones(240, np.float32)
        jt, tt = _both(
            lambda: J.factor(J.plan(csr, J.SaPOptions(variant="auto", **kw))).solve(b),
            lambda: T.factor(T.plan(tcsr, T.SaPOptions(variant="auto", **kw),
                                    device="cpu")).solve(b),
        )
    else:
        if case == "C":
            kw.update(variant="C")
        else:
            kw.update(variant="E", reduced_solver="bcr")
        band, b = _band(d=1.1 if case == "C" else 0.5), _rhs(256)
        jt, tt = _both(
            lambda: J.factor(J.plan_banded(band, J.SaPOptions(**kw))).solve(b),
            lambda: T.factor(T.plan_banded(band, T.SaPOptions(**kw), device="cpu")).solve(b),
        )
    smoke = _smoke()
    want = smoke.TRACE_TREES[case]
    assert _names(_tree(jt)) == want and _names(_tree(tt)) == want
    assert all(smoke.trace_port_only(sp) == _port_only(sp) for sp in tt.walk())
    assert any(_port_only(sp) for sp in tt.walk())


# ---------------------------------------------------------------------------
# the port's own: counters, the Krylov loop's sub-spans, the clock, and the
# stage spans timed on the card without waiting
# ---------------------------------------------------------------------------


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _lifecycle(kw, tracer=None, nrhs=None, d=0.5):
    """Plan, factor and solve a small system (under ``tracer`` if given);
    the result and the counters' steps over the factor and the solve."""
    band = _band(d=d)
    b = _rhs(256) if nrhs is None else np.stack([_rhs(256, s) for s in range(nrhs)], axis=1)
    opts = T.SaPOptions(**dict(dict(p=4, tol=1e-7, maxiter=300), **kw))
    with use_tracer(tracer):
        c0 = trace_mod.counters()
        fac = T.factor(T.plan_banded(band, opts, device="cpu"))
        c1 = trace_mod.counters()
        res = fac.solve(b) if nrhs is None else fac.solve_many(b)
        c2 = trace_mod.counters()
    return res, _delta(c0, c1), _delta(c1, c2)


@pytest.mark.parametrize("case,nrhs", [("D", None), ("C", None), ("E_bcr", None), ("D", 3)])
def test_counters_per_solve_at_a_small_case(case, nrhs):
    """A factor reads the card once (its degree of dominance); a BiCGStab(2)
    run once before its first sweep and once after each (whole sweeps + 1)
    and applies the preconditioner twice at its start and four times a
    sweep; a block of R columns is one run, as long as its slowest column."""
    res, fac_steps, solve_steps = _lifecycle(LIFECYCLE[case], nrhs=nrhs)
    sweeps = math.ceil(float(res.iterations.max()))
    assert sweeps >= 2  # the loop's check runs after more than one sweep
    assert fac_steps == {"solves": 0, "host_syncs": 1, "precond_applies": 0}
    assert solve_steps == {"solves": 1, "host_syncs": sweeps + 1,
                           "precond_applies": 4 * sweeps + 2}
    # tracing changes none of them
    _, traced_fac, traced_solve = _lifecycle(LIFECYCLE[case], Tracer(), nrhs=nrhs)
    assert (traced_fac, traced_solve) == (fac_steps, solve_steps)


def test_only_the_stage_spans_wait_for_the_card(monkeypatch):
    """Of every span a traced lifecycle opens, only ``factor`` and
    ``krylov`` wait for the card when they close."""
    tr = Tracer()
    waited = []
    monkeypatch.setattr(trace_mod, "_wait_for_card", lambda v: waited.append(tr._stack()[-1].name))
    for kw in LIFECYCLE.values():
        _lifecycle(kw, tr)
    assert waited == ["factor", "krylov"] * len(LIFECYCLE)
    assert {s.name for s in tr.walk()} >= {"factor.split", "factor.lu", "factor.fused",
                                           "factor.spike", "factor.reduced"}


def test_the_convergence_digest_is_read_when_the_span_is(monkeypatch):
    """The traced solve computes no convergence digest (a host read of
    device state); reading the ``krylov`` span's attributes computes it
    once, as Python scalars."""
    from repro_torch.core import sap as sap_mod

    calls = []
    real = sap_mod._convergence_summary
    monkeypatch.setattr(sap_mod, "_convergence_summary",
                        lambda *a: calls.append(1) or real(*a))
    tr = Tracer()
    res, _, _ = _lifecycle(LIFECYCLE["C"], tr)
    assert calls == []
    conv = tr.find("krylov")[0].attrs["convergence"]
    assert calls == [1] and conv["converged"] is True
    assert conv["iterations"] == float(res.iterations) and isinstance(conv["resnorm"], float)
    tr.find("krylov")[0].attrs
    assert calls == [1]


def test_krylov_sub_span_tree():
    """Inside ``krylov``: start (a matvec, two applies), a check before the
    first sweep and after each, each sweep four matvecs and four applies,
    finish (the true residual's matvec); BCR's levels under
    ``factor.reduced``; a ``plan`` span in ``plan_banded``."""
    tr = Tracer()
    res, _, _ = _lifecycle(LIFECYCLE["E_bcr"], tr)
    sweeps = math.ceil(float(res.iterations))
    (kr,) = tr.find("krylov")

    def names(sp):
        return [c.name for c in sorted(sp.children, key=lambda c: c.t0)]

    assert names(kr) == (["krylov.start", "krylov.check"] + ["krylov.sweep", "krylov.check"] * sweeps
                         + ["krylov.finish"])
    assert names(tr.find("krylov.start")[0]) == ["krylov.matvec", "krylov.precond",
                                                 "krylov.precond"]
    for sw in tr.find("krylov.sweep"):
        assert names(sw) == ["krylov.matvec", "krylov.precond"] * 4
    assert names(tr.find("krylov.finish")[0]) == ["krylov.matvec"]
    assert all(not c.children for c in tr.find("krylov.check"))
    (red,) = tr.find("factor.reduced")
    assert [c.attrs["level"] for c in red.children] == [0, 1]  # 3 interfaces padded to 4
    assert set(names(red)) == {"factor.reduced.level"}
    (pl,) = tr.find("plan")
    assert pl.attrs == {"banded": True, "n": 256, "k": 4}
    assert set(kr.attrs["launches"]) == set() and tr.find("factor")[0].attrs["launches"] == {}


def test_span_times_are_on_the_profilers_clock():
    """Every span's open and close lie within 100 us of its
    ``record_function`` range in a ``torch.profiler`` capture of the same
    run, and the Chrome export's ``ts`` is the span's clock in us."""
    import torch

    def traced():
        tr = Tracer(annotate_device=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _lifecycle(LIFECYCLE["C"], tr)
        return tr, prof

    traced()  # the first ranges of a process pay a one-off start-up
    tr, prof = traced()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    spans = {}
    for sp in tr.walk():
        spans.setdefault(sp.name, []).append((sp.t0, sp.t1))
    assert len(spans) >= 10
    for name, got in spans.items():
        want = sorted(ranges[name])
        assert len(want) == len(got), name
        for (t0, t1), (r0, r1) in zip(sorted(got), want):
            assert abs(t0 - r0) <= 100_000 and abs(t1 - r1) <= 100_000, (name, t0 - r0, t1 - r1)
    begins = {e["name"]: e["ts"] for e in tr.to_chrome_events() if e["ph"] == "B"}
    assert begins["factor"] == pytest.approx(tr.find("factor")[0].t0 / 1e3, abs=1.0)


class _FakeEvent:
    """A CUDA event's timing interface, on a given time (ms)."""

    def __init__(self, ms):
        self.ms, self.synced = ms, False

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_device_span_reads_its_event_pair_when_read(monkeypatch):
    """A device span records an event at open and at close on a CUDA
    device, none elsewhere, and waits for nothing; its ``device_s`` comes
    from the pair when first read, and the summary and the export show
    it."""
    import torch

    times, made = iter([1.0, 3.5]), []
    monkeypatch.setattr(trace_mod, "_record_event",
                        lambda dev: made.append(_FakeEvent(next(times))) or made[-1])
    monkeypatch.setattr(trace_mod, "_wait_for_card", lambda v: pytest.fail("waited"))
    tr = Tracer()
    with use_tracer(tr):
        with trace_mod.device_span("factor", torch.device("cpu")):
            with trace_mod.device_span("factor.lu", torch.device("cuda", 0), p=4) as sp:
                pass
    assert len(made) == 2 and not made[1].synced
    assert sp.device_s == pytest.approx(2.5e-3) and made[1].synced
    assert tr.find("factor")[0].device_s is None
    assert trace_mod.span("x") is NULL_SPAN and trace_mod.device_span("x", "cuda") is NULL_SPAN
    lines = tr.summary().splitlines()
    assert lines[0].split()[-1] == "device"
    assert lines[2].split()[0] == "factor.lu" and lines[2].endswith("2.500 ms")
    args = {e["name"]: e["args"] for e in tr.to_chrome_events() if e["ph"] == "B"}
    assert args["factor.lu"] == {"p": 4, "device_s": pytest.approx(2.5e-3)}
    assert "device_s" not in args["factor"]


def test_counters_are_a_snapshot():
    c = trace_mod.counters()
    assert set(c) == {"solves", "host_syncs", "precond_applies"}
    c["solves"] += 100
    trace_mod.count("solves", 0)
    assert trace_mod.counters()["solves"] == c["solves"] - 100
