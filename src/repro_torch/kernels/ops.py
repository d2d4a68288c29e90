"""Public entry points of the block-tridiagonal kernels.

Dispatch goes by tensor device alone: the wrappers in :mod:`.btf`,
:mod:`.bts`, :mod:`.fused_spike` and :mod:`.bcr` run the plain PyTorch
version for a CPU tensor and launch the CUDA kernel for a CUDA tensor.
This module adds the factor containers, the single-chain forms (the SaP-E
reduced interface system), the per-partition coupling layout of the fused
pass and the level loops of block cyclic reduction.
"""

from __future__ import annotations

import torch

from ..core.block_lu import DEFAULT_BOOST, BTFactors, FusedSpikeFactors, pad_couplings
from ..core.cyclic_reduction import BCRFactors, BCRLevel, pad_chain, pad_rhs
from . import bcr
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


def bcr_factor(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BCRFactors:
    """Block cyclic reduction factor of one chain (M, K, K) in log2(M)
    levels (pair with :func:`bcr_solve`); ``e[0]`` / ``f[M-1]`` are ignored.
    Per level, ``inv_odd`` inverts the odd diagonal blocks and ``reduce``
    builds ``lo``/``hi`` and the half-length chain; the root block goes
    through ``inv_odd``'s kernel as well."""
    m = d.shape[0]
    d, e, f = (t.contiguous() for t in pad_chain(d, e, f))
    levels = []
    while d.shape[0] > 1:
        a_odd = bcr.inv_odd(d, boost_eps)
        lo, hi, d_next, e_next, f_next = bcr.reduce(d, e, f, a_odd)
        levels.append(BCRLevel(lo=lo, hi=hi, a_odd=a_odd,
                               e_odd=e[1::2].contiguous(), f_odd=f[1::2].contiguous()))
        d, e, f = d_next, e_next, f_next
    root_inv = bcr.inv_odd(d, boost_eps, first=0)[0]
    return BCRFactors(levels=tuple(levels), root_inv=root_inv, m=m)


def bcr_solve(factors: BCRFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve one BCR-factored chain: b (M, K, R) -> x (M, K, R).  The root
    apply ``root_inv @ b_0`` is one plain product, as in the JAX package."""
    b = pad_rhs(b.contiguous(), factors.n_levels)
    rhs = []
    for lv in factors.levels:
        rhs.append(b)
        b = bcr.rhs_reduce(lv.lo, lv.hi, b)
    x = (factors.root_inv @ b[0])[None]
    for lv, bl in zip(reversed(factors.levels), reversed(rhs)):
        x = bcr.backsub(lv.a_odd, lv.e_odd, lv.f_odd, bl, x)
    return x[: factors.m]
