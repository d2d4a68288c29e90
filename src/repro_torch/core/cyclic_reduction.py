"""Block cyclic reduction for the SaP-E reduced chain.

Only the ``"auto"`` policy is ported so far; ``bcr_factor`` / ``bcr_solve``
and their kernels are the next slice of the port (see ROADMAP.md).
"""

from __future__ import annotations


def resolve_reduced_solver(reduced_solver: str, m: int) -> str:
    """The ``"auto"`` policy for the SaP-E reduced chain solver.

    Cyclic reduction wins once the chain is long enough for its log-depth
    to beat the sequential sweep's lower constant; short chains (few
    partitions) stay on the ``btf_chain`` sweep.
    """
    if reduced_solver not in ("chain", "bcr", "auto"):
        raise ValueError(f"unknown reduced_solver {reduced_solver!r}")
    if reduced_solver != "auto":
        return reduced_solver
    return "bcr" if m >= 8 else "chain"
