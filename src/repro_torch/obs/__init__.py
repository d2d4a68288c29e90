"""Observability: lifecycle tracing and roofline cost accounting."""

from .cost import (
    StageCost,
    device_memory_bytes,
    hardware_spec,
    solver_stage_costs,
    stage_cost,
)
from .trace import (
    NULL_SPAN,
    Span,
    Tracer,
    count,
    counters,
    device_span,
    get_tracer,
    quiet,
    record,
    span,
    use_tracer,
)

__all__ = [
    "NULL_SPAN",
    "Span",
    "StageCost",
    "Tracer",
    "count",
    "counters",
    "device_memory_bytes",
    "device_span",
    "get_tracer",
    "hardware_spec",
    "quiet",
    "record",
    "solver_stage_costs",
    "span",
    "stage_cost",
    "use_tracer",
]
