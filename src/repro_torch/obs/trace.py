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
and semantics.  Design constraints:

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
- **Honest device timing.**  Kernel launches return before the card has
  run them; a span that launches device work calls ``sp.sync(result)``,
  and at span exit it records a CUDA event on the current stream of the
  result's device and waits for it before taking the end timestamp.
  A result holding no CUDA tensor (the CPU path) waits for nothing.
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

    def sync(self, value: Any) -> Any:
        """No-op passthrough; mirrors Span.sync."""
        return value

    @property
    def duration_s(self) -> float:
        """Always 0.0 for the disabled span."""
        return 0.0


NULL_SPAN = _NullSpan()


class Span:
    """A timed, attributed region.  Created via ``Tracer.span`` / ``span()``."""

    __slots__ = ("name", "attrs", "t0", "t1", "tid", "children", "_tracer", "_pending", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0
        self.children: List[Span] = []
        self._tracer = tracer
        self._pending: Any = None
        self._ann = None

    def __bool__(self) -> bool:
        return True

    def annotate(self, **attrs: Any) -> "Span":
        """Attach attributes after entry (e.g. values computed inside the span)."""
        self.attrs.update(attrs)
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
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:  # pragma: no cover - profiler unavailable
                self._ann = None
        self.t0 = tracer.clock()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._pending is not None and self._tracer.device_sync:
            try:
                _wait_for_card(self._pending)
            except Exception:
                pass
            self._pending = None
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
        return max(self.t1 - self.t0, 0.0)

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
    """

    def __init__(
        self,
        enabled: bool = True,
        device_sync: bool = True,
        annotate_device: bool = False,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.enabled = enabled
        self.device_sync = device_sync
        self.annotate_device = annotate_device
        self.clock = clock
        self._epoch = clock()
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

    def record(self, name: str, t0: float, t1: float, tid: Optional[int] = None,
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

    def now(self) -> float:
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

    def clear(self) -> None:
        """Drop all recorded spans."""
        with self._lock:
            self._roots = []

    # -- exporters ----------------------------------------------------------

    def to_chrome_events(self) -> List[Dict[str, Any]]:
        """Span forest as Chrome trace_event ``B``/``E`` pairs (ts in µs)."""
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
            ts0 = (sp.t0 - self._epoch) * 1e6
            ts1 = (sp.t1 - self._epoch) * 1e6
            events.append(
                {"name": sp.name, "ph": "B", "pid": pid, "tid": sp.tid, "ts": ts0,
                 "args": {k: _jsonable(v) for k, v in sp.attrs.items()}}
            )
            for c in sorted(sp.children, key=lambda s: s.t0):
                emit(c)
            events.append({"name": sp.name, "ph": "E", "pid": pid, "tid": sp.tid, "ts": ts1})

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
        """Human-readable stage tree: spans merged by name at each depth.

        ``min_frac`` hides merged nodes below that fraction of their parent.
        """
        lines = [f"{'span':<44} {'total':>12} {'count':>6} {'% parent':>9}"]

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
                lines.append(f"{label:<44} {fmt_t(total):>12} {len(group):>6} {pct}")
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


def record(name: str, t0: float, t1: float, **attrs: Any) -> None:
    """Retroactive root span on the active tracer (timestamps from ``tracer.now()``)."""
    t = _ACTIVE
    if t is not None:
        t.record(name, t0, t1, **attrs)
