"""SaP on PyTorch and CUDA: the split-and-parallelize banded solver (Li,
Serban, Negrut 2015) ported from the JAX package ``repro`` to an NVIDIA
H100, with hand-written CUDA kernels for the block-tridiagonal factor,
solve and fused factor+spike passes and for block cyclic reduction, and
the sparse DB/CM front end on the host; beside it the RWKV6 and Zamba2
serving path (:mod:`.models`, :mod:`.serve`), whose sequence mixers run
the same split-and-parallelize idea along the sequence axis on two more
CUDA kernels.  Imports no JAX."""

from .core import (
    SaPFactorization,
    SaPOptions,
    SaPPlan,
    SaPSolveResult,
    factor,
    plan,
    plan_banded,
    solve_sparse,
)

__version__ = "0.1.0"

__all__ = [
    "SaPFactorization",
    "SaPOptions",
    "SaPPlan",
    "SaPSolveResult",
    "factor",
    "plan",
    "plan_banded",
    "solve_sparse",
]
