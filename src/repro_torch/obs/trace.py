"""End-to-end solve tracing: nested spans, Chrome/Perfetto export, stage trees.

The tracer answers the question the source paper answers with its stage
tables: where does a solve spend its time -- reordering (DB/CM), LU+SPIKE
factorization, or Krylov iteration?  Usage:

    from repro_torch.obs import Tracer, use_tracer

    tracer = Tracer()
    with use_tracer(tracer):
        fac = factor(plan(a, opts))
        res = fac.solve(b)
    print(tracer.summary())
    tracer.export_chrome("trace.json")   # open at ui.perfetto.dev

The JAX package's ``repro.obs.trace`` ported to torch, with the same API
and semantics, and three additions of the port's own: timestamps on the
profiler's clock, spans timed on the card by a CUDA-event pair
(:func:`device_span`), and process-wide counters (:func:`counters`).
Design constraints:

- **Zero overhead when disabled.**  The module-level ``span()`` helper
  returns a shared no-op singleton when no tracer is active (one global
  read + one ``is None`` check); instrumented code never pays for
  timestamps, dict churn, or lock traffic unless a tracer is installed.
- **Capture-safe.**  During a CUDA-graph capture a host timestamp means
  nothing and a synchronize would raise, so ``span()`` degrades to the
  no-op span while the current stream is capturing.  Inside a
  ``with quiet():`` block it degrades too, on that thread: the batched
  factor runs the single-system stages over a fleet, whose spans the JAX
  package's ``vmap`` degrades the same way.
- **Thread-safe.**  Span nesting is tracked per-thread (the async serving
  drain thread traces concurrently with client threads); finished roots
  are collected under a lock.
- **One clock with the device trace.**  Span timestamps are integer
  nanoseconds of the Unix epoch (``time.time_ns``), the clock that
  ``torch.profiler`` anchors its events to, so a span lies over the
  ``record_function`` range of the same name in a profile of the same
  run, and the Chrome export's ``ts`` (microseconds of the epoch) over the
  events of the profiler's export (whose ``ts`` count from its
  ``baseTimeNanoseconds``).
- **Honest device timing, and no wait that the untraced run lacks below
  the stage spans.**  Kernel launches return before the card has run
  them; a stage span (``factor``, ``krylov``) that launches device work
  calls ``sp.sync(result)``, and at span exit it records a CUDA event on
  the current stream of the result's device and waits for it before
  taking the end timestamp.  A span opened by :func:`device_span` waits
  for nothing: it records a CUDA event on the stream at open and at
  close, and reads the pair's elapsed time (``Span.device_s``) only when
  the span is read.  Attributes attached with ``Span.defer`` (the
  ``krylov`` span's convergence digest) are computed when first read too,
  so tracing adds no host read of device state to the traced code.  A
  result holding no CUDA tensor (the CPU path) waits for nothing and has
  no device time.
- **Counters beside the spans.**  :func:`count` adds to a process-wide
  integer counter whether or not a tracer is active; :func:`counters`
  returns a snapshot.  The solver counts its Krylov runs (``solves``),
  its host reads of device state (``host_syncs``) and its preconditioner
  applies (``precond_applies``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "count",
    "counters",
    "device_span",
    "get_tracer",
    "quiet",
    "record",
    "span",
    "use_tracer",
]


def _under_capture() -> bool:
    """True while the current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


_QUIET = threading.local()


class quiet:
    """Degrade every span opened on this thread inside the block to the
    no-op span (nestable)."""

    def __enter__(self) -> "quiet":
        _QUIET.depth = getattr(_QUIET, "depth", 0) + 1
        return self

    def __exit__(self, *exc: Any) -> bool:
        _QUIET.depth -= 1
        return False


def _cuda_devices(value: Any, out: set) -> set:
    """Devices of the CUDA tensors anywhere in ``value`` (tensors, tuples,
    lists, dicts and dataclasses, nested)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for fld in dataclasses.fields(value):
            _cuda_devices(getattr(value, fld.name), out)
    return out


def _wait_for_card(value: Any) -> None:
    """Block until the work queued so far on the current stream of every
    device ``value``'s CUDA tensors live on has run."""
    for dev in _cuda_devices(value, set()):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def _profiler_range(name: str):
    """A ``torch.profiler`` range of ``name`` as a context manager: the
    C++ guard where torch has it (one recorded event, no operator calls:
    under a profiler ``record_function`` costs two recorded operator calls
    more a range), else ``record_function``."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast is not None else torch.profiler.record_function(name)


def _record_event(device: torch.device):
    """A timing CUDA event recorded now on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _jsonable(v: Any) -> Any:
    """Coerce an attribute value to something the trace_event format accepts."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
            return repr(v)  # NaN/inf are not valid strict JSON
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:  # numpy / torch scalars
        if getattr(v, "ndim", None) == 0:
            return _jsonable(v.item())
    except Exception:
        pass
    return str(v)


class _NullSpan:
    """Shared no-op span: every tracer API is a cheap constant method."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def annotate(self, **attrs: Any) -> "_NullSpan":
        """No-op; mirrors Span.annotate."""
        return self

    def defer(self, name: str, fn: Callable[[], Any]) -> "_NullSpan":
        """No-op; mirrors Span.defer (``fn`` is never called)."""
        return self

    def sync(self, value: Any) -> Any:
        """No-op passthrough; mirrors Span.sync."""
        return value

    @property
    def duration_s(self) -> float:
        """Always 0.0 for the disabled span."""
        return 0.0

    @property
    def device_s(self) -> None:
        """Always None for the disabled span."""
        return None


NULL_SPAN = _NullSpan()


class Span:
    """A timed, attributed region.  Created via ``Tracer.span`` / ``span()``
    or ``Tracer.device_span`` / ``device_span()``.

    ``t0`` / ``t1`` are the tracer's clock (Unix-epoch nanoseconds by
    default); ``device_s`` is the card's time between the span's open and
    close (a device span on a CUDA device) or None.
    """

    __slots__ = ("name", "_attrs", "t0", "t1", "tid", "children", "_tracer", "_pending", "_ann",
                 "_device", "_events", "_device_s", "_deferred")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 device: Optional[torch.device] = None):
        self.name = name
        self._attrs = attrs
        self.t0 = 0
        self.t1 = 0
        self.tid = 0
        self.children: List[Span] = []
        self._tracer = tracer
        self._pending: Any = None
        self._ann = None
        self._device = device if device is not None and device.type == "cuda" else None
        self._events: Optional[tuple] = None
        self._device_s: Optional[float] = None
        self._deferred: Optional[Dict[str, Callable[[], Any]]] = None

    def __bool__(self) -> bool:
        return True

    @property
    def attrs(self) -> Dict[str, Any]:
        """The span's attributes, deferred ones computed on this first read."""
        if self._deferred:
            deferred, self._deferred = self._deferred, None
            for name, fn in deferred.items():
                self._attrs[name] = fn()
        return self._attrs

    def annotate(self, **attrs: Any) -> "Span":
        """Attach attributes after entry (e.g. values computed inside the span)."""
        self._attrs.update(attrs)
        return self

    def defer(self, name: str, fn: Callable[[], Any]) -> "Span":
        """Attach attribute ``name`` as ``fn()``, called when the span's
        attributes are first read: a value that needs a host read of device
        state costs the traced code nothing."""
        if self._deferred is None:
            self._deferred = {}
        self._deferred[name] = fn
        return self

    def sync(self, value: Any) -> Any:
        """Register tensors (or a structure holding them) to wait for at
        span exit.

        Returns ``value`` unchanged so call sites can wrap an expression:
        ``res = sp.sync(fac.solve(b))``.
        """
        self._pending = value
        return value

    def __enter__(self) -> "Span":
        tracer = self._tracer
        self.tid = threading.get_ident()
        tracer._stack().append(self)
        if tracer.annotate_device:
            try:
                self._ann = _profiler_range(self.name)
                self._ann.__enter__()
            except Exception:  # pragma: no cover - profiler unavailable
                self._ann = None
        if self._device is not None:
            self._events = (_record_event(self._device),)
        self.t0 = tracer.clock()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._pending is not None and self._tracer.device_sync:
            try:
                _wait_for_card(self._pending)
            except Exception:
                pass
            self._pending = None
        if self._events is not None:
            self._events = (self._events[0], _record_event(self._device))
        self.t1 = self._tracer.clock()
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:  # pragma: no cover
                pass
            self._ann = None
        self._tracer._finish(self)
        return False

    @property
    def duration_s(self) -> float:
        """Wall seconds between span open and close."""
        return max(self.t1 - self.t0, 0) * 1e-9

    @property
    def device_s(self) -> Optional[float]:
        """Seconds the card took between the span's open and close, read
        from its CUDA-event pair on first use (waiting for the close event
        then); None for a host span or off the card."""
        if self._events is not None and len(self._events) == 2:
            start, end = self._events
            end.synchronize()
            self._device_s = start.elapsed_time(end) * 1e-3
            self._events = None
        return self._device_s

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Span({self.name!r}, {self.duration_s * 1e3:.3f} ms, attrs={self.attrs})"


class Tracer:
    """Collects a forest of spans across threads.

    Parameters
    ----------
    enabled:
        When False every ``span()`` returns the no-op singleton; an
        instrumented code path costs one attribute read per span site.
    device_sync:
        When True (default), spans that registered a value via
        ``sp.sync(x)`` wait for the card (a CUDA event on the current
        stream of x's device) before taking the end timestamp, so
        durations reflect device completion rather than the launches.
    annotate_device:
        When True, each host span also opens a
        ``torch.profiler.record_function`` of the same name, so spans line
        up with the kernels inside ``torch.profiler.profile`` captures.
    clock:
        Integer nanoseconds; the default, ``time.time_ns``, is the Unix
        epoch that ``torch.profiler`` stamps its events on.
    """

    def __init__(
        self,
        enabled: bool = True,
        device_sync: bool = True,
        annotate_device: bool = False,
        clock: Callable[[], int] = time.time_ns,
    ):
        self.enabled = enabled
        self.device_sync = device_sync
        self.annotate_device = annotate_device
        self.clock = clock
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._roots: List[Span] = []

    # -- collection ---------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def span(self, name: str, **attrs: Any):
        """Open a nested span; use as a context manager."""
        if not self.enabled or getattr(_QUIET, "depth", 0) or _under_capture():
            return NULL_SPAN
        return Span(self, name, attrs)

    def device_span(self, name: str, device: torch.device, **attrs: Any):
        """A span that also times the card's work between its open and
        close on ``device``'s current stream (``Span.device_s``), without
        waiting for it."""
        if not self.enabled or getattr(_QUIET, "depth", 0) or _under_capture():
            return NULL_SPAN
        return Span(self, name, attrs, torch.device(device))

    def record(self, name: str, t0: int, t1: int, tid: Optional[int] = None,
               **attrs: Any) -> None:
        """Add a retroactive root span from externally captured timestamps.

        Timestamps must come from this tracer's clock (``tracer.now()``);
        the async service uses this to emit one span per request covering
        submit->resolve, which no single ``with`` block brackets.
        """
        if not self.enabled:
            return
        sp = Span(self, name, dict(attrs))
        sp.t0, sp.t1 = t0, t1
        sp.tid = threading.get_ident() if tid is None else tid
        with self._lock:
            self._roots.append(sp)

    def now(self) -> int:
        """Current timestamp on this tracer's clock (for ``record``)."""
        return self.clock()

    def _finish(self, sp: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:  # mis-nested exit (shouldn't happen); recover rather than corrupt
            try:
                stack.remove(sp)
            except ValueError:
                pass
        if stack:
            stack[-1].children.append(sp)
        else:
            with self._lock:
                self._roots.append(sp)

    # -- queries ------------------------------------------------------------

    def roots(self) -> List[Span]:
        """Top-level finished spans, ordered by start time."""
        with self._lock:
            return sorted(self._roots, key=lambda s: s.t0)

    def walk(self) -> Iterator[Span]:
        """All finished spans, depth-first."""
        def rec(sp: Span) -> Iterator[Span]:
            yield sp
            for c in sp.children:
                yield from rec(c)

        for r in self.roots():
            yield from rec(r)

    def find(self, name: str) -> List[Span]:
        """All finished spans with the given name."""
        return [s for s in self.walk() if s.name == name]

    def durations(self) -> Dict[str, float]:
        """Total seconds per span name (summed over occurrences)."""
        out: Dict[str, float] = {}
        for s in self.walk():
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    # -- exporters ----------------------------------------------------------

    def to_chrome_events(self) -> List[Dict[str, Any]]:
        """Span forest as Chrome trace_event ``B``/``E`` pairs (``ts`` in
        microseconds of the tracer's clock: the Unix epoch by default); a
        span timed on the card carries ``device_s`` in its ``args``."""
        events: List[Dict[str, Any]] = []
        pid = os.getpid()
        events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "repro_torch.solve"}}
        )
        seen_tids = set()

        def emit(sp: Span) -> None:
            if sp.tid not in seen_tids:
                seen_tids.add(sp.tid)
                events.append(
                    {"name": "thread_name", "ph": "M", "pid": pid, "tid": sp.tid,
                     "args": {"name": f"thread-{sp.tid}"}}
                )
            args = {k: _jsonable(v) for k, v in sp.attrs.items()}
            if sp.device_s is not None:
                args["device_s"] = sp.device_s
            events.append(
                {"name": sp.name, "ph": "B", "pid": pid, "tid": sp.tid, "ts": sp.t0 / 1e3,
                 "args": args}
            )
            for c in sorted(sp.children, key=lambda s: s.t0):
                emit(c)
            events.append({"name": sp.name, "ph": "E", "pid": pid, "tid": sp.tid,
                           "ts": sp.t1 / 1e3})

        for r in self.roots():
            emit(r)
        return events

    def export_chrome(self, path: str) -> str:
        """Write a Chrome/Perfetto trace_event JSON file; returns the path."""
        doc = {"traceEvents": self.to_chrome_events(), "displayTimeUnit": "ms"}
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return path

    def summary(self, min_frac: float = 0.0) -> str:
        """Human-readable stage tree: spans merged by name at each depth,
        with the card's time of the spans timed on it (``device``).

        ``min_frac`` hides merged nodes below that fraction of their parent.
        """
        lines = [f"{'span':<44} {'total':>12} {'count':>6} {'% parent':>9} {'device':>12}"]

        def merge(spans: List[Span]) -> List[tuple]:
            groups: Dict[str, List[Span]] = {}
            order: List[str] = []
            for s in spans:
                if s.name not in groups:
                    groups[s.name] = []
                    order.append(s.name)
                groups[s.name].append(s)
            return [(n, groups[n]) for n in order]

        def fmt_t(sec: float) -> str:
            if sec >= 1.0:
                return f"{sec:.3f} s"
            if sec >= 1e-3:
                return f"{sec * 1e3:.3f} ms"
            return f"{sec * 1e6:.1f} us"

        def rec(spans: List[Span], depth: int, parent_total: Optional[float]) -> None:
            for name, group in merge(spans):
                total = sum(s.duration_s for s in group)
                frac = (total / parent_total) if parent_total else None
                if frac is not None and frac < min_frac:
                    continue
                pct = f"{frac * 100.0:8.1f}%" if frac is not None else " " * 9
                label = "  " * depth + name
                dev = [s.device_s for s in group if s.device_s is not None]
                dev_t = fmt_t(sum(dev)) if dev else ""
                lines.append(f"{label:<44} {fmt_t(total):>12} {len(group):>6} {pct} {dev_t:>12}")
                rec([c for s in group for c in s.children], depth + 1, total)

        rec(self.roots(), 0, None)
        return "\n".join(lines)


# -- module-level active tracer ---------------------------------------------
#
# A plain module global (not a contextvar): the async serving layer hands
# work to a background drain thread, which must inherit the tracer the
# client installed.  ``use_tracer`` is therefore process-wide; nested use
# restores the previous tracer on exit.

_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()


class use_tracer:
    """Install ``tracer`` as the process-wide active tracer for a ``with`` block."""

    def __init__(self, tracer: Optional[Tracer]):
        self.tracer = tracer
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Optional[Tracer]:
        global _ACTIVE
        with _ACTIVE_LOCK:
            self._prev = _ACTIVE
            _ACTIVE = self.tracer
        return self.tracer

    def __exit__(self, *exc: Any) -> bool:
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = self._prev
        return False


def get_tracer() -> Optional[Tracer]:
    """The currently active tracer, or None."""
    return _ACTIVE


def span(name: str, **attrs: Any):
    """Open a span on the active tracer; no-op (and allocation-free) without one."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def device_span(name: str, device: torch.device, **attrs: Any):
    """Open a span timed on the card (``Tracer.device_span``) on the active
    tracer; no-op without one."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.device_span(name, device, **attrs)


def record(name: str, t0: int, t1: int, **attrs: Any) -> None:
    """Retroactive root span on the active tracer (timestamps from ``tracer.now()``)."""
    t = _ACTIVE
    if t is not None:
        t.record(name, t0, t1, **attrs)


# -- counters ------------------------------------------------------------------
#
# Process-wide and always on, tracer or not: one dict add a count.  The
# solver counts its Krylov runs, its host reads of device state and its
# preconditioner applies; a reader takes differences of two snapshots, or
# a whole process's totals.

_COUNTS: Dict[str, int] = {"solves": 0, "host_syncs": 0, "precond_applies": 0}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :func:`counters`' keys)."""
    _COUNTS[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of this process's counters since it started."""
    return dict(_COUNTS)
