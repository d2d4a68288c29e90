"""Async multi-tenant solve service: futures, deadlines, priorities.

:class:`AsyncSolverService` turns the synchronous :class:`SolverEngine`
into a serving subsystem.  Clients on any thread call
:meth:`AsyncSolverService.submit` and get a :class:`SolveFuture` back
immediately; a background **drain thread** forms device batches and
resolves the futures.  The drain thread launches every kernel, on the
engine's device (``torch.cuda.device`` held for the thread's life); a
future resolves with host numpy results, after the step's device work
has finished (``kernels/build.py:load`` holds a lock, so a first build
never runs twice when threads meet it).  The pieces:

* **Futures** -- ``submit()`` returns a :class:`SolveFuture`
  (``threading.Event``-backed): ``result(timeout)`` blocks for the
  outcome, ``done()``/``cancelled()`` poll, ``cancel()`` withdraws a
  not-yet-scheduled request.

* **Overlap** -- the expensive host-side request prep (band fingerprint,
  dominance estimate, bucket shape) runs on the *submitting* thread,
  outside every lock, while the drain thread's device solve is in
  flight.  Arrival work and device work overlap instead of serializing,
  which is where the async throughput win over sequential
  ``submit``+``run_until_drained`` comes from.

* **Scheduling** -- requests carry ``priority`` (higher first) and
  ``deadline_s``.  The drain thread picks the scheduling class with the
  highest-priority pending request, tie-breaking by earliest deadline
  (EDF), and drains up to ``max_batch`` of its requests.  Requests whose
  deadline already passed are **shed** with a :class:`Cancelled` outcome
  instead of occupying batch slots.

* **Admission control** -- the pending set is bounded by ``queue_cap``:
  ``submit(block=False)`` raises :class:`QueueFull`, ``block=True``
  (default) applies backpressure by blocking the caller.  An LRU-thrash
  guard watches the engine's eviction rate and widens the bucket
  rounding ("exact" -> "pow2") when the factorization cache churns, so a
  long tail of one-off shapes stops evicting the working set.

* **Per-class options** -- each request is routed to a dominance class
  from its host-side d estimate (paper Eq. 2.11): ``d >= 1`` solves with
  the cheap truncated variant "C", ``d < 1`` with the exact reduced
  system "E" + log-depth BCR -- per-bucket options replacing the
  engine's single shared ``SaPOptions`` (the sub-structuring-as-
  preconditioner view of arXiv:2108.13162: route by spectral character,
  don't average over it).

* **Metrics** -- a :class:`repro_torch.serve.metrics.MetricsRegistry`
  records queue depth, time-in-queue, batch occupancy, cache hits/misses,
  deadline misses, peak device bytes and solves/sec; ``snapshot()`` is
  JSON-ready, ``render()`` the Prometheus text.  The misconvergence
  guard is observable too: ``misconverged_total`` counts solves whose
  iteration claimed convergence while the true residual failed the
  guard, ``escalations`` counts the exact-bucket re-solves the engine
  ran in response (see :class:`repro_torch.serve.solver_engine.SolveOutcome`).
  The JAX service's compile counters (``recompiles``,
  ``compile_seconds``) count XLA compiles, which have no counterpart here.

* **Tracing** -- under an active :class:`repro_torch.obs.Tracer` each
  dispatch is a ``serve.dispatch`` span around the engine's
  ``engine.solve_prepared``, and each request a retroactive
  ``serve.request`` root span from submit to resolve.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import batched
from ..core.sap import SaPOptions
from ..obs.trace import get_tracer, span
from .metrics import MetricsRegistry
from .solver_engine import (
    SolveOutcome,
    SolveRequest,
    SolverEngine,
    band_dominance,
    matrix_fingerprint,
)

DOMINANT = "dom"  # d >= 1: spike truncation justified (variant "C")
NON_DOMINANT = "nondom"  # d < 1: exact reduced system required ("E")


class QueueFull(RuntimeError):
    """Admission control rejected a submit (queue at ``queue_cap``)."""


class SolveCancelled(RuntimeError):
    """Raised by :meth:`SolveFuture.result` when the request was shed."""

    def __init__(self, reason: str):
        super().__init__(f"solve cancelled: {reason}")
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class Cancelled:
    """Terminal non-solve outcome (deadline shed / client cancel / ...)."""

    reason: str  # "deadline" | "client" | "shutdown" | "error: ..."


class SolveFuture:
    """Handle for one in-flight solve; resolves exactly once.

    ``outcome(timeout)`` returns either a
    :class:`~repro_torch.serve.solver_engine.SolveOutcome` or a
    :class:`Cancelled`; ``result(timeout)`` is the strict form that
    raises :class:`SolveCancelled` on shed/cancel (the
    ``concurrent.futures`` convention).
    """

    def __init__(self, rid: int):
        self.rid = rid
        self._event = threading.Event()
        self._outcome: SolveOutcome | Cancelled | None = None
        self._cancel_requested = False

    # -- client side --------------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return isinstance(self._outcome, Cancelled)

    def cancel(self) -> bool:
        """Request withdrawal; honored only if not yet scheduled.

        Best-effort: the drain thread drops cancel-requested tickets at
        scheduling time, but a request already inside a device batch
        completes normally.  Returns False only when the future already
        resolved non-cancelled; True means cancellation happened or may
        still happen.
        """
        self._cancel_requested = True
        return not self.done() or self.cancelled()

    def outcome(self, timeout: Optional[float] = None):
        """Block for the terminal outcome: SolveOutcome | Cancelled."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"solve future rid={self.rid} unresolved after {timeout}s"
            )
        return self._outcome

    def result(self, timeout: Optional[float] = None) -> SolveOutcome:
        out = self.outcome(timeout)
        if isinstance(out, Cancelled):
            raise SolveCancelled(out.reason)
        return out

    # -- service side -------------------------------------------------------

    def _resolve(self, outcome) -> None:
        if self._event.is_set():  # first resolution wins
            return
        self._outcome = outcome
        self._event.set()


@dataclasses.dataclass
class _Ticket:
    """A submitted request waiting in the service's scheduling queues."""

    rid: int
    band: np.ndarray
    b: np.ndarray
    fingerprint: str
    dclass: str
    bucket: Tuple[int, int, int]
    priority: int
    deadline: Optional[float]  # absolute time.monotonic(), None = none
    t_submit: float
    future: SolveFuture
    t_trace: float = 0.0  # tracer-clock submit time (0.0 = no tracer)

    def sort_key(self):
        # higher priority first, then earliest deadline (EDF), then FIFO
        return (
            -self.priority,
            self.deadline if self.deadline is not None else float("inf"),
            self.rid,
        )


def default_class_overrides(base: SaPOptions) -> Dict[str, SaPOptions]:
    """The per-dominance-class options the service routes batches to."""
    return {
        DOMINANT: dataclasses.replace(base, variant="C"),
        NON_DOMINANT: dataclasses.replace(
            base, variant="E", reduced_solver="bcr"
        ),
    }


class AsyncSolverService:
    """Asynchronous multi-tenant front end over :class:`SolverEngine`.

    Parameters
    ----------
    opts            : base solver options; per-class overrides derive from
                      it (``class_overrides`` replaces them wholesale --
                      every override must keep the same ``p``).
    max_batch       : per-dispatch batch cap (one bucket per dispatch)
    cache_size      : engine LRU capacity (factorizations)
    rounding        : initial bucket rounding ("pow2" | "exact"); the
                      thrash guard may widen "exact" to "pow2" at runtime
    queue_cap       : max pending requests before admission control kicks in
    default_deadline_s : deadline applied when submit() passes none
    thrash_window   : evaluate the thrash guard every this-many solves
    thrash_ratio    : evictions/solve above which rounding widens
    class_overrides : per-dominance-class SaPOptions overrides
    metrics         : optional shared MetricsRegistry
    hist_bounds     : upper bucket edges for the latency-style histograms
                      (``time_in_queue_s``); None keeps
                      :data:`repro_torch.serve.metrics.DEFAULT_BOUNDS`.
                      Settable from
                      :class:`repro_torch.configs.sap_solver.SolverConfig`
                      (``hist_bounds``).
    cost_accounting : attribute roofline-predicted costs to every engine
                      step (:class:`SolverEngine`'s ``cost_accounting``)
    start           : spawn the drain thread immediately (tests pass
                      False and call ``drain_once()`` deterministically)
    device          : the engine's device (default: the card)
    """

    def __init__(
        self,
        opts: Optional[SaPOptions] = None,
        *,
        max_batch: int = 32,
        cache_size: int = 128,
        rounding: str = "pow2",
        queue_cap: int = 256,
        default_deadline_s: Optional[float] = None,
        thrash_window: int = 32,
        thrash_ratio: float = 0.5,
        class_overrides: Optional[Dict[str, SaPOptions]] = None,
        metrics: Optional[MetricsRegistry] = None,
        hist_bounds: Optional[Tuple[float, ...]] = None,
        cost_accounting: bool = False,
        start: bool = True,
        device=None,
    ):
        base = opts or SaPOptions()
        self.engine = SolverEngine(
            base, max_batch=max_batch, cache_size=cache_size,
            rounding=rounding, cost_accounting=cost_accounting, device=device,
        )
        self.max_batch = max_batch
        self.rounding = rounding
        self.queue_cap = queue_cap
        self.default_deadline_s = default_deadline_s
        self.thrash_window = thrash_window
        self.thrash_ratio = thrash_ratio
        self.class_overrides = (
            dict(class_overrides)
            if class_overrides is not None
            else default_class_overrides(base)
        )
        for cls, o in self.class_overrides.items():
            if o.p != base.p:
                raise ValueError(
                    f"class override {cls!r} changes p ({o.p} != {base.p}); "
                    "buckets are keyed by the base partition count"
                )
        self.metrics = metrics or MetricsRegistry()
        m = self.metrics
        occupancy = tuple(i / 16 for i in range(1, 17))
        depth = tuple(float(x) for x in
                      (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._m_submitted = m.counter("submitted")
        self._m_solved = m.counter("solved")
        self._m_shed = m.counter("deadline_misses")
        self._m_cancelled = m.counter("client_cancels")
        self._m_rejected = m.counter("queue_rejections")
        self._m_widened = m.counter("rounding_widenings")
        self._m_hits = m.counter("cache_hits")
        self._m_misses = m.counter("cache_misses")
        # misconvergence guard: solves whose Krylov iteration claimed
        # convergence but whose TRUE residual failed the guard, and the
        # exact-bucket escalation re-solves the engine ran in response
        self._m_misconverged = m.counter("misconverged_total")
        self._m_escalations = m.counter("escalations")
        # memory pressure: the engine's device high-water mark, synced at
        # the end of every drain
        self._m_peak_bytes = m.gauge("peak_device_bytes")
        self._m_depth = m.histogram("queue_depth", depth)
        self._m_wait = m.histogram("time_in_queue_s", hist_bounds)
        self._m_occ = m.histogram("batch_occupancy", occupancy)
        self._m_pending = m.gauge("pending_now")

        # scheduling state: (bucket, dclass) -> [tickets]; one condition
        # variable serves submitters (backpressure) and the drain thread.
        self._cv = threading.Condition()
        self._pending: Dict[Tuple, List[_Ticket]] = {}
        self._n_pending = 0
        self._rid = itertools.count()
        self._closing = False
        self._t_start = time.monotonic()
        self._last_thrash_check = (0, 0)  # (evictions, solved) at last check
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._drain_loop, name="sap-serve-drain", daemon=True
        )
        self._thread.start()

    def close(self, drain: bool = True, timeout: Optional[float] = 60.0):
        """Stop the service.  ``drain=True`` finishes queued work first;
        ``drain=False`` sheds everything pending as Cancelled("shutdown")."""
        with self._cv:
            self._closing = True
            if not drain:
                for t in self._drop_all():
                    t.future._resolve(Cancelled("shutdown"))
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # whatever the drain thread left behind (e.g. join timeout)
        with self._cv:
            for t in self._drop_all():
                t.future._resolve(Cancelled("shutdown"))

    def __enter__(self) -> "AsyncSolverService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=not any(exc))

    # -- submission (client threads) ----------------------------------------

    def submit(
        self,
        band,
        b,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> SolveFuture:
        """Enqueue one banded system; returns immediately with a future.

        Host-side prep (fingerprint hash, dominance estimate, bucket
        shape) runs here on the *caller's* thread, outside every lock --
        submission work overlaps the drain thread's in-flight device
        solves.  ``block`` selects the backpressure behavior when the
        queue sits at ``queue_cap``: block (optionally up to ``timeout``
        seconds) or raise :class:`QueueFull` right away.
        """
        if self._closing:
            raise RuntimeError("service is closed")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        band = np.asarray(band)
        b = np.asarray(b)
        fp = matrix_fingerprint(band)
        d = band_dominance(band)
        dclass = DOMINANT if d >= 1.0 else NON_DOMINANT
        n, k = band.shape[0], (band.shape[1] - 1) // 2
        now = time.monotonic()
        tr = get_tracer()
        t_trace = tr.now() if tr else 0.0
        fut = SolveFuture(next(self._rid))
        with self._cv:
            while self._n_pending >= self.queue_cap and not self._closing:
                if not block:
                    self._m_rejected.inc()
                    raise QueueFull(
                        f"{self._n_pending} pending >= cap {self.queue_cap}"
                    )
                if not self._cv.wait(timeout):
                    self._m_rejected.inc()
                    raise QueueFull(
                        f"no queue slot within {timeout}s "
                        f"(cap {self.queue_cap})"
                    )
            if self._closing:
                raise RuntimeError("service is closed")
            # bucket under the lock: the thrash guard flips self.rounding
            bucket = batched.bucket_shape(n, k, self.engine.opts.p,
                                          self.rounding)
            ticket = _Ticket(
                rid=fut.rid, band=band, b=b, fingerprint=fp, dclass=dclass,
                bucket=bucket, priority=priority,
                deadline=(now + deadline_s) if deadline_s is not None
                else None,
                t_submit=now, future=fut, t_trace=t_trace,
            )
            self._pending.setdefault((bucket, dclass), []).append(ticket)
            self._n_pending += 1
            self._m_submitted.inc()
            self._m_depth.observe(self._n_pending)
            self._m_pending.set(self._n_pending)
            self._cv.notify_all()
        return fut

    # -- scheduling + drain (drain thread) ----------------------------------

    def _drop_all(self) -> List[_Ticket]:
        """Clear every queue (caller holds the lock); returns the tickets."""
        dropped = [t for ts in self._pending.values() for t in ts]
        self._pending.clear()
        self._n_pending = 0
        self._m_pending.set(0)
        self._cv.notify_all()
        return dropped

    def _shed_locked(self, now: float) -> List[_Ticket]:
        """Remove expired / client-cancelled tickets (caller holds lock)."""
        shed: List[Tuple[_Ticket, str]] = []
        for key in list(self._pending):
            keep = []
            for t in self._pending[key]:
                if t.future._cancel_requested:
                    shed.append((t, "client"))
                elif t.deadline is not None and t.deadline < now:
                    shed.append((t, "deadline"))
                else:
                    keep.append(t)
            if keep:
                self._pending[key] = keep
            else:
                del self._pending[key]
        if shed:
            self._n_pending -= len(shed)
            self._m_pending.set(self._n_pending)
            self._cv.notify_all()  # slots freed: wake blocked submitters
        for t, reason in shed:
            (self._m_shed if reason == "deadline"
             else self._m_cancelled).inc()
            t.future._resolve(Cancelled(reason))
        return [t for t, _ in shed]

    def _select_locked(self) -> Optional[Tuple[Tuple, List[_Ticket]]]:
        """Pick the next batch (caller holds the lock).

        Scheduling class = (bucket, dominance class).  The class owning
        the globally best ticket -- highest priority, then earliest
        deadline -- wins the dispatch; up to ``max_batch`` of its tickets
        go out in the same order.  Starvation-resistant in the useful
        sense: a class only waits while strictly better work exists.
        """
        best_key, best = None, None
        for key, tickets in self._pending.items():
            head = min(tickets, key=_Ticket.sort_key)
            if best is None or head.sort_key() < best.sort_key():
                best_key, best = key, head
        if best_key is None:
            return None
        tickets = sorted(self._pending[best_key], key=_Ticket.sort_key)
        batch, rest = tickets[: self.max_batch], tickets[self.max_batch:]
        if rest:
            self._pending[best_key] = rest
        else:
            del self._pending[best_key]
        self._n_pending -= len(batch)
        self._m_pending.set(self._n_pending)
        self._cv.notify_all()
        return best_key, batch

    def drain_once(self) -> int:
        """Shed expired work, dispatch at most one batch; returns the
        number of futures resolved.  The drain loop's body -- public so
        tests (and single-threaded callers) can run the scheduler
        deterministically without a background thread."""
        with self._cv:
            self._shed_locked(time.monotonic())
            picked = self._select_locked()
        if picked is None:
            return 0
        (bucket, dclass), tickets = picked
        opts = self.class_overrides[dclass]
        reqs = [
            SolveRequest(rid=t.rid, band=t.band, b=t.b,
                         fingerprint=t.fingerprint)
            for t in tickets
        ]
        try:
            # the device batch: runs outside the condition variable, so
            # submitters keep hashing/enqueueing while this is in flight;
            # its outcomes are host arrays, so the device work has ended
            with span(
                "serve.dispatch",
                bucket=f"{bucket[0]}x{bucket[1]}",
                dclass=dclass,
                batch=len(tickets),
            ):
                self.engine.solve_prepared(reqs, bucket, opts=opts)
        except Exception as e:  # resolve, never hang the futures
            for t in tickets:
                t.future._resolve(Cancelled(f"error: {e!r}"))
            return len(tickets)
        now = time.monotonic()
        tr = get_tracer()
        hits = 0
        mis = esc = 0
        for t, r in zip(tickets, reqs):
            hits += bool(r.result.cache_hit)
            # an escalated outcome replaced a misconverged first pass, so
            # it counts as a misconvergence even if the re-solve cured it
            esc += bool(r.result.escalated)
            mis += bool(r.result.escalated or r.result.misconverged)
            self._m_wait.observe(now - t.t_submit)
            t.future._resolve(r.result)
            if tr is not None and t.t_trace > 0.0:
                # retroactive per-request span: queue -> dispatch -> resolve
                tr.record(
                    "serve.request",
                    t.t_trace,
                    tr.now(),
                    rid=t.rid,
                    dclass=t.dclass,
                    bucket=f"{t.bucket[0]}x{t.bucket[1]}",
                    queue_s=round(now - t.t_submit, 6),
                    cache_hit=bool(r.result.cache_hit),
                )
        self._m_solved.inc(len(tickets))
        self._m_hits.inc(hits)
        self._m_misses.inc(len(tickets) - hits)
        if mis:
            self._m_misconverged.inc(mis)
        if esc:
            self._m_escalations.inc(esc)
        self._m_occ.observe(len(tickets) / self.max_batch)
        self._check_thrash()
        self._m_peak_bytes.set_max(self.engine.stats_snapshot()["peak_device_bytes"])
        return len(tickets)

    def _drain_loop(self) -> None:
        dev = self.engine.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            while True:
                with self._cv:
                    while not self._n_pending and not self._closing:
                        self._cv.wait()
                    if self._closing and not self._n_pending:
                        return
                self.drain_once()

    def _check_thrash(self) -> None:
        """Widen bucket rounding when the factorization LRU churns.

        Under "exact" rounding a spread of one-off (N, K) shapes makes
        every shape its own bucket; if the eviction rate over the last
        ``thrash_window`` solves exceeds ``thrash_ratio``, collapse the
        shape space by switching to "pow2" rounding (logarithmically many
        buckets), which lets near-miss shapes share cache entries instead
        of evicting each other.  Already-queued tickets keep their old
        bucket; only new arrivals see the widened rounding.
        """
        stats = self.engine.stats_snapshot()
        ev, solved = stats["evictions"], stats["solved"]
        ev0, solved0 = self._last_thrash_check
        if solved - solved0 < self.thrash_window:
            return
        rate = (ev - ev0) / max(solved - solved0, 1)
        self._last_thrash_check = (ev, solved)
        if rate > self.thrash_ratio and self.rounding == "exact":
            with self._cv:
                if self.rounding == "exact":
                    self.rounding = "pow2"
                    self._m_widened.inc()

    # -- observability ------------------------------------------------------

    @property
    def pending(self) -> int:
        with self._cv:
            return self._n_pending

    def render(self) -> str:
        """Prometheus text exposition of the service's metrics registry.

        Serve over HTTP with content type ``text/plain; version=0.0.4``
        and a stock Prometheus scraper ingests it as-is.
        """
        return self.metrics.to_prometheus()

    def snapshot(self) -> dict:
        """JSON-ready view: service metrics + engine counters + derived."""
        snap = self.metrics.snapshot()
        snap["engine"] = self.engine.stats_snapshot()
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        solved = snap["counters"].get("solved", 0.0)
        served = solved + snap["counters"].get("deadline_misses", 0.0)
        hits = snap["counters"].get("cache_hits", 0.0)
        misses = snap["counters"].get("cache_misses", 0.0)
        snap["derived"] = {
            "uptime_s": round(elapsed, 6),
            "solves_per_second": round(solved / elapsed, 3),
            "requests_per_second": round(served / elapsed, 3),
            "cache_hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            "rounding": self.rounding,
        }
        return snap
