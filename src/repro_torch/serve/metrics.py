"""Serving metrics: thread-safe counters / gauges / histograms.

The metrics layer for :class:`repro_torch.serve.service.AsyncSolverService`
(and anything else in ``serve/``): a tiny prometheus-shaped registry --
monotonic :class:`Counter`, point-in-time :class:`Gauge`, and a
fixed-bucket :class:`Histogram` with quantile estimates -- that snapshots
to a plain dict (JSON-ready) and renders the Prometheus text exposition
format.  Pure Python: the JAX package's registry, line for line.

Every instrument takes its own lock on update, so the drain thread, any
number of submitting client threads, and a scraping thread can all touch
the registry concurrently.  Updates are O(1) and allocation-free on the
hot path (histograms pre-size their bucket counts).
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

# Default histogram bounds: latency-ish seconds spanning us..minutes, also
# serviceable for small counts (queue depth, batch occupancy percentages).
DEFAULT_BOUNDS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonically increasing count (requests, misses, evictions...)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Point-in-time level (queue depth now, cached factorizations now)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    def set_max(self, v: float) -> None:
        """Raise the gauge to ``v`` if higher (watermark semantics)."""
        v = float(v)
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bound histogram with count/sum/min/max and quantile estimates.

    ``bounds`` are the inclusive upper edges of the first ``len(bounds)``
    buckets; one overflow bucket catches the rest.  Quantiles are read
    from the cumulative bucket counts (the value reported is the upper
    edge of the bucket the quantile falls in -- the usual prometheus-style
    estimate), so they are conservative but lock-cheap.
    """

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name} needs sorted, non-empty bounds")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of quantile ``q`` in [0, 1].

        Edge behavior is exact, not bucket-interpolated: an *empty*
        histogram returns NaN for every ``q`` (there is no observation to
        estimate from); ``q=0`` returns the observed minimum and ``q=1``
        the observed maximum, since the tracked min/max are exact while
        bucket edges would only bound them.  Interior quantiles report
        the upper edge of the bucket the rank falls in (the conservative
        prometheus-style estimate).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._count == 0:
                return float("nan")
            if q == 0.0:
                return self._min
            if q == 1.0:
                return self._max
            rank = q * self._count
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank and c:
                    if i < len(self.bounds):
                        return self.bounds[i]
                    return self._max  # overflow bucket: best bound we have
            return self._max

    def _exposition_data(self) -> tuple:
        """(bounds, per-bucket counts, count, sum) under one lock hold."""
        with self._lock:
            return self.bounds, list(self._counts), self._count, self._sum

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            counts = list(self._counts)
            vmin, vmax = self._min, self._max
        snap = {
            "count": count,
            "sum": round(total, 9),
            "mean": round(total / count, 9) if count else float("nan"),
            "min": vmin if count else float("nan"),
            "max": vmax if count else float("nan"),
            "buckets": {
                ("+inf" if i == len(self.bounds) else repr(self.bounds[i])): c
                for i, c in enumerate(counts)
                if c
            },
        }
        for q in (0.5, 0.9, 0.99):
            snap[f"p{int(q * 100)}"] = self.quantile(q)
        return snap


class MetricsRegistry:
    """Get-or-create registry of named instruments; snapshots to a dict.

    One registry per service.  ``counter``/``gauge``/``histogram`` are
    idempotent per name (re-registering with different bounds raises), so
    hot-path call sites can look instruments up by name without caching
    handles -- though caching the handle is cheaper still.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._check_free(name, self._counters)
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._check_free(name, self._gauges)
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> Histogram:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                self._check_free(name, self._histograms)
                hist = Histogram(name, bounds or DEFAULT_BOUNDS)
                self._histograms[name] = hist
            elif bounds is not None and tuple(bounds) != hist.bounds:
                raise ValueError(
                    f"histogram {name!r} already registered with different "
                    f"bounds"
                )
            return hist

    def _check_free(self, name: str, owner: dict) -> None:
        for family in (self._counters, self._gauges, self._histograms):
            if family is not owner and name in family:
                raise ValueError(
                    f"metric name {name!r} already used by another type"
                )

    def snapshot(self) -> dict:
        """One coherent-enough dict of every instrument (JSON-ready)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.snapshot() for n, c in counters.items()},
            "gauges": {n: g.snapshot() for n, g in gauges.items()},
            "histograms": {n: h.snapshot() for n, h in histograms.items()},
        }

    def to_prometheus(self, prefix: str = "") -> str:
        """Every instrument in the Prometheus text exposition format.

        Counters carry the conventional ``_total`` suffix; histograms emit
        *cumulative* ``_bucket{le="..."}`` series (including the ``+Inf``
        catch-all) plus ``_sum`` / ``_count``.  Names are sanitized to the
        prometheus charset.  Serve the result over HTTP with content type
        ``text/plain; version=0.0.4`` and it scrapes directly.
        """
        lines = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        for n, c in sorted(counters.items()):
            pn = _prom_name(prefix + n)
            if not pn.endswith("_total"):
                pn += "_total"
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {_prom_value(c.value)}")
        for n, g in sorted(gauges.items()):
            pn = _prom_name(prefix + n)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_value(g.value)}")
        for n, h in sorted(histograms.items()):
            pn = _prom_name(prefix + n)
            bounds, counts, count, total = h._exposition_data()
            lines.append(f"# TYPE {pn} histogram")
            cum = 0
            for b, c in zip(bounds, counts):
                cum += c
                lines.append(f'{pn}_bucket{{le="{_prom_value(b)}"}} {cum}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{pn}_sum {_prom_value(total)}")
            lines.append(f"{pn}_count {count}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return f"_{n}" if n and n[0].isdigit() else n


def _prom_value(v: float) -> str:
    return format(float(v), ".10g")
