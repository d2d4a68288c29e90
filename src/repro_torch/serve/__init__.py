"""Serving on the port: the continuous-batching LM decode engine, and the
solver's batched engine and asynchronous multi-tenant service."""

from .engine import Request, ServeEngine
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .service import (
    AsyncSolverService,
    Cancelled,
    QueueFull,
    SolveCancelled,
    SolveFuture,
    default_class_overrides,
)
from .solver_engine import (
    SolveOutcome,
    SolveRequest,
    SolverEngine,
    band_dominance,
    matrix_fingerprint,
)

__all__ = [
    "AsyncSolverService",
    "Cancelled",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "QueueFull",
    "Request",
    "ServeEngine",
    "SolveCancelled",
    "SolveFuture",
    "SolveOutcome",
    "SolveRequest",
    "SolverEngine",
    "band_dominance",
    "default_class_overrides",
    "matrix_fingerprint",
]
