"""SaP core on PyTorch: split-and-parallelize banded linear solvers.

The port of :mod:`repro.core` to PyTorch and CUDA, slice by slice.  It
covers band storage, block-tridiagonal factorization, SPIKE
preconditioning (variants C, D and E, with the chain or the block cyclic
reduction reduced solver), the Krylov solvers and the sparse DB/CM front
end, behind the lifecycle ``factor(plan(a, opts)).solve(b)`` (or
``plan_banded`` for band storage).
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
from .cyclic_reduction import (
    BCRFactors,
    BCRLevel,
    bcr_factor,
    bcr_solve,
    pad_chain,
    resolve_reduced_solver,
)
from .krylov import (
    KrylovResult,
    bicgstab2,
    bicgstab2_many,
    cg,
    cg_many,
    refine,
    refine_many,
)
from .operators import (
    BandedOperator,
    CsrOperator,
    LinearOperator,
    as_matvec,
    as_operator,
    require_square_dense,
)
from .reorder import ReorderPlan, analyze
from .sap import (
    SaPFactorization,
    SaPOptions,
    SaPPlan,
    SaPSolution,
    SaPSolveResult,
    factor,
    plan,
    plan_banded,
    resolve_solver,
    resolve_variant,
    solve_banded,
    solve_sparse,
)
from .sparse import CSR, csr_from_coo, csr_from_dense, random_sparse
from .spike import SaPPreconditioner, build_preconditioner

__all__ = [
    "BandedOperator",
    "BCRFactors",
    "BCRLevel",
    "BlockTridiag",
    "BTFactors",
    "CSR",
    "CsrOperator",
    "FusedSpikeFactors",
    "KrylovResult",
    "LinearOperator",
    "ReorderPlan",
    "SaPFactorization",
    "SaPOptions",
    "SaPPlan",
    "SaPPreconditioner",
    "SaPSolution",
    "SaPSolveResult",
    "analyze",
    "as_matvec",
    "as_operator",
    "band_matvec",
    "band_to_block_tridiag",
    "band_to_dense",
    "bcr_factor",
    "bcr_solve",
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
    "csr_from_coo",
    "csr_from_dense",
    "dense_to_band",
    "diag_dominance_factor",
    "factor",
    "factorization_from_numpy",
    "fused_factor_spike_ref",
    "gj_inverse",
    "oscillatory_banded",
    "pad_banded",
    "pad_chain",
    "padded_partition_size",
    "plan",
    "plan_banded",
    "random_banded",
    "random_rhs",
    "random_sparse",
    "refine",
    "refine_many",
    "require_square_dense",
    "resolve_reduced_solver",
    "resolve_solver",
    "resolve_variant",
    "solve_banded",
    "solve_sparse",
]
