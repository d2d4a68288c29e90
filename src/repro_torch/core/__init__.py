"""SaP core on PyTorch: split-and-parallelize banded linear solvers.

The port of :mod:`repro.core` to PyTorch and CUDA, slice by slice.  This
slice covers the dense banded path: band storage, block-tridiagonal
factorization, SPIKE preconditioning (variants C, D and E with the chain
reduced solver) and the Krylov solvers, behind the lifecycle
``factor(plan_banded(band, opts)).solve(b)``.
"""

from .banded import (
    BlockTridiag,
    band_matvec,
    band_to_block_tridiag,
    band_to_dense,
    dense_to_band,
    diag_dominance_factor,
    oscillatory_banded,
    pad_banded,
    padded_partition_size,
    random_banded,
    random_rhs,
)
from .block_lu import (
    BTFactors,
    FusedSpikeFactors,
    btf_chain,
    btf_ref,
    btf_ul_ref,
    bts_chain,
    bts_ref,
    fused_factor_spike_ref,
    gj_inverse,
)
from .convert import factorization_from_numpy
from .cyclic_reduction import resolve_reduced_solver
from .krylov import (
    KrylovResult,
    bicgstab2,
    bicgstab2_many,
    cg,
    cg_many,
    refine,
    refine_many,
)
from .operators import BandedOperator, LinearOperator
from .sap import (
    SaPFactorization,
    SaPOptions,
    SaPPlan,
    SaPSolution,
    SaPSolveResult,
    factor,
    plan_banded,
    resolve_solver,
    resolve_variant,
    solve_banded,
)
from .spike import SaPPreconditioner, build_preconditioner

__all__ = [
    "BandedOperator",
    "BlockTridiag",
    "BTFactors",
    "FusedSpikeFactors",
    "KrylovResult",
    "LinearOperator",
    "SaPFactorization",
    "SaPOptions",
    "SaPPlan",
    "SaPPreconditioner",
    "SaPSolution",
    "SaPSolveResult",
    "band_matvec",
    "band_to_block_tridiag",
    "band_to_dense",
    "bicgstab2",
    "bicgstab2_many",
    "btf_chain",
    "btf_ref",
    "btf_ul_ref",
    "bts_chain",
    "bts_ref",
    "build_preconditioner",
    "cg",
    "cg_many",
    "dense_to_band",
    "diag_dominance_factor",
    "factor",
    "factorization_from_numpy",
    "fused_factor_spike_ref",
    "gj_inverse",
    "oscillatory_banded",
    "pad_banded",
    "padded_partition_size",
    "plan_banded",
    "random_banded",
    "random_rhs",
    "refine",
    "refine_many",
    "resolve_reduced_solver",
    "resolve_solver",
    "resolve_variant",
    "solve_banded",
]
