"""Public entry points of the block-tridiagonal kernels.

Dispatch goes by tensor device alone: the wrappers in :mod:`.btf`,
:mod:`.bts` and :mod:`.fused_spike` run the plain PyTorch version for a CPU
tensor and launch the CUDA kernel for a CUDA tensor.  This module adds the
factor containers, the single-chain forms (the SaP-E reduced interface
system) and the per-partition coupling layout of the fused pass.
"""

from __future__ import annotations

import torch

from ..core.block_lu import DEFAULT_BOOST, BTFactors, FusedSpikeFactors, pad_couplings
from .btf import btf
from .bts import bts
from .fused_spike import fused_factor_spike as _fused


def block_tridiag_factor(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """Block-tridiagonal LU factor of (P, M, K, K) chains."""
    sinv, l = btf(d, e, f, boost_eps)
    return BTFactors(sinv=sinv, l=l, f=f)


def block_tridiag_solve(factors: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve the factored chains for (P, M, K, R) right-hand sides."""
    return bts(factors.sinv, factors.l, factors.f, b)


def block_tridiag_factor_chain(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """Factor a single block-tridiagonal chain (M, K, K): one partition.
    The factors keep the leading singleton partition axis."""
    return block_tridiag_factor(d[None], e[None], f[None], boost_eps)


def block_tridiag_solve_chain(factors: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve one factored chain: b (M, K, R) -> x (M, K, R)."""
    return block_tridiag_solve(factors, b[None])[0]


def fused_factor_spike(
    d: torch.Tensor,
    e: torch.Tensor,
    f: torch.Tensor,
    b_cpl: torch.Tensor,
    c_cpl: torch.Tensor,
    boost_eps: float = DEFAULT_BOOST,
) -> FusedSpikeFactors:
    """Fused block-LU factor + spike-corner extraction in one pass.

    d/e/f: (P, M, K, K) partition blocks; b_cpl/c_cpl: (P-1, K, K)
    interface couplings.  ``lu`` and ``v_bot`` / ``w_top`` equal the
    btf -> UL-btf sequence; ``v_top`` / ``w_bot`` are algebraically equal to
    the whole-spike solves (forward carries instead of back-substitution).
    """
    p = d.shape[0]
    bq, cq = pad_couplings(b_cpl.to(d.dtype), c_cpl.to(d.dtype), p)
    sinv, l, vb, vt, wt, wb = _fused(d, e, f, bq, cq, boost_eps)
    return FusedSpikeFactors(
        lu=BTFactors(sinv=sinv, l=l, f=f),
        v_bot=vb[:-1],
        v_top=vt[:-1],
        w_top=wt[1:],
        w_bot=wb[1:],
    )
