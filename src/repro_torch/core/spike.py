"""SPIKE machinery: truncated spikes, reduced system, SaP preconditioner.

Implements paper Sec. 2.1:

  * right-spike bottom blocks   V_i^(b) = Sinv_i[M-1] @ B_i          (2.2a)
  * left-spike top blocks       W_{i+1}^(t) via the UL factorization (2.2c)
  * the truncated reduced system (2.9):
        Rbar_i               = I - W_{i+1}^(t) V_i^(b)
        Rbar_i xt_{i+1}^(t)  = g_{i+1}^(t) - W_{i+1}^(t) g_i^(b)
        xt_i^(b)             = g_i^(b) - V_i^(b) xt_{i+1}^(t)
  * the final decoupled solves (2.10).

Three preconditioner variants (paper Sec. 2.1.1):
  * SaP-D  ("decoupled"): z = D^{-1} r, one block solve.
  * SaP-C  ("coupled"):   block solve + truncated-spike correction +
                          second block solve.
  * SaP-E  ("exact"):     block solve + *exact* reduced-system correction +
                          second block solve.  The full (P-1)-interface
                          reduced system is a block-tridiagonal chain of
                          (2K x 2K) blocks, factored and solved either by
                          the same btf / bts kernels as the partitions (an
                          O(P) sequential sweep) or by block cyclic
                          reduction (O(log2 P) parallel levels).

Reduced system (exact; unknowns y_i = [x_i^(b); x_{i+1}^(t)], i = 0..P-2):

    [ I            V_i^(b) ]        [ W_i^(b) 0 ]        [ 0  0          ]
    [ W_{i+1}^(t)  I       ] y_i  + [ 0       0 ] y_{i-1} + [ 0  V_{i+1}^(t) ] y_{i+1}
        = [ g_i^(b); g_{i+1}^(t) ]

Every factor and solve goes through :mod:`repro_torch.kernels.ops`, which
launches the CUDA kernels for tensors on the card and runs the plain
versions for tensors on the CPU.

A fleet of S systems split alike (:mod:`repro_torch.core.batched`) goes
through the same code with a leading system axis on every tensor: the
partition axis is always the fourth from the end, and each kernel call
folds the systems into its chain axis, so a factor or an apply launches
each kernel as often for S systems as for one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import ops as kops
from ..obs.trace import count, device_span
from .banded import BlockTridiag
from .block_lu import DEFAULT_BOOST, BTFactors, flip_block_tridiag
from .cyclic_reduction import BCRFactors, resolve_reduced_solver


def _flip_rows(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-2)


@dataclasses.dataclass
class SaPPreconditioner:
    """Factored SaP preconditioner ('C' coupled, 'D' decoupled, 'E' exact).

    All factor tensors may be stored in a lower precision than the Krylov
    iteration (paper Sec. 3.1 "Mixed Precision Strategy").  For a fleet
    every tensor carries a leading system axis (S, ...); the shape fields
    are shared.
    """

    variant: str  # "C" | "D" | "E"
    lu: BTFactors  # factors of diag(A_1..A_P)
    b_cpl: torch.Tensor  # (P-1, K, K)
    c_cpl: torch.Tensor  # (P-1, K, K)
    v_bot: Optional[torch.Tensor]  # (P-1, K, K)  V_i^(b)
    w_top: Optional[torch.Tensor]  # (P-1, K, K)  W_{i+1}^(t)
    rbar_inv: Optional[torch.Tensor]  # (P-1, K, K)  inv(I - W V)
    red_lu: Optional[BTFactors]  # factors of the exact (P-1, 2K) reduced chain
    red_bcr: Optional[BCRFactors]  # log-depth BCR factors of the same chain
    p: int
    m: int
    k: int
    # resolved reduced-chain solver for variant E ("chain" = sequential
    # btf/bts sweep, "bcr" = block cyclic reduction); "none" otherwise
    reduced_solver: str = "none"
    # True when the factor+spike stage ran as the fused single pass
    fused: bool = False

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Apply M^{-1} to a (padded) residual of shape (P*M*K,) or
        (P*M*K, R); for a fleet, (S, P*M*K, R).  Counts one of
        ``precond_applies``."""
        count("precond_applies")
        dtype = self.lu.sinv.dtype
        lead = self.lu.sinv.shape[:-4]
        rb = r.to(dtype).reshape(lead + (self.p, self.m, self.k, -1)).contiguous()
        if self.variant == "D":
            z = kops.block_tridiag_solve(self.lu, rb)
        elif self.variant == "E":
            z = _apply_exact(self, rb)
        else:
            z = _apply_coupled(self, rb)
        return z.reshape(r.shape).to(r.dtype)


def resolve_fused(fused, device: torch.device) -> bool:
    """Resolve the ``fused_factor`` knob: ``"auto"`` means fused where the
    tensors are on the card (the kernel keeps the UL recurrence and spike
    carries out of device-memory round trips) and the btf -> UL -> spike
    sequence on the CPU."""
    if fused in (True, "on"):
        return True
    if fused in (None, False, "off"):
        return False
    if fused == "auto":
        return torch.device(device).type == "cuda"
    raise ValueError(f"unknown fused_factor setting {fused!r}")


def _correct(pc: SaPPreconditioner, rb, xt_bot, xt_top):
    """Final solves (eq. 2.10): subtract the coupling contributions."""
    rb2 = rb.clone()
    rb2[..., 1:, 0, :, :] -= pc.c_cpl @ xt_bot  # into partitions 1..P-1, top block
    rb2[..., :-1, -1, :, :] -= pc.b_cpl @ xt_top  # into partitions 0..P-2, bottom block
    return kops.block_tridiag_solve(pc.lu, rb2)


def _apply_coupled(pc: SaPPreconditioner, rb: torch.Tensor) -> torch.Tensor:
    # 1) g = D^{-1} r
    g = kops.block_tridiag_solve(pc.lu, rb)  # ([S,] P, M, K, R)
    g_top = g[..., 0, :, :]
    g_bot = g[..., -1, :, :]
    # 2) reduced-system correction per interface i = 0..P-2   (eq. 2.9)
    rhs = g_top[..., 1:, :, :] - pc.w_top @ g_bot[..., :-1, :, :]
    xt_top = pc.rbar_inv @ rhs  # xt_{i+1}^(t)
    xt_bot = g_bot[..., :-1, :, :] - pc.v_bot @ xt_top  # xt_i^(b)
    return _correct(pc, rb, xt_bot, xt_top)


def _apply_exact(pc: SaPPreconditioner, rb: torch.Tensor) -> torch.Tensor:
    """SaP-E apply: an exact solve of the banded preconditioner matrix."""
    g = kops.block_tridiag_solve(pc.lu, rb)
    # exact reduced system on the interface unknowns; its RHS is just the
    # interface slices of g
    h = torch.cat([g[..., :-1, -1, :, :], g[..., 1:, 0, :, :]], dim=-2)  # ([S,] P-1, 2K, R)
    if pc.reduced_solver == "bcr":
        y = kops.bcr_solve(pc.red_bcr, h)
    else:
        y = kops.block_tridiag_solve_chain(pc.red_lu, h)
    return _correct(pc, rb, y[..., : pc.k, :], y[..., pc.k :, :])


def _reduced_interface_system(v_bot, v_top, w_top, w_bot):
    """Assemble the exact (P-1)-interface block-tridiag chain (2K blocks).

    Inputs are the four corner blocks of the whole spikes, each (P-1, K, K)
    (or (S, P-1, K, K) for a fleet): v_bot/v_top index right spikes of
    partitions 0..P-2, w_top/w_bot left spikes of partitions 1..P-1.
    Returns (d, e, f) of shape ([S,] P-1, 2K, 2K); e[0] / f[P-2] are zero.
    """
    k = v_bot.shape[-1]
    eye = torch.eye(k, dtype=v_bot.dtype, device=v_bot.device)
    rd = v_bot.new_zeros(v_bot.shape[:-2] + (2 * k, 2 * k))
    re = torch.zeros_like(rd)
    rf = torch.zeros_like(rd)
    rd[..., :k, :k] = eye
    rd[..., :k, k:] = v_bot
    rd[..., k:, :k] = w_top
    rd[..., k:, k:] = eye
    # y_{i-1} contributes W_i^(b) x_{i-1}^(b); y_{i+1} contributes
    # V_{i+1}^(t) x_{i+2}^(t) (see module docstring).
    re[..., 1:, :k, :k] = w_bot[..., :-1, :, :]
    rf[..., :-1, k:, k:] = v_top[..., 1:, :, :]
    return rd, re, rf


def _block_inverse(a: torch.Tensor, boost_eps: float) -> torch.Tensor:
    """Boosted Gauss-Jordan inverse of (..., K, K) blocks: the btf pass on
    chains of one block row, whose factor is exactly ``gj_inverse`` -- one
    launch whatever the leading axes."""
    k = a.shape[-1]
    flat = a.reshape(-1, 1, k, k).contiguous()
    z = torch.zeros_like(flat)
    return kops.block_tridiag_factor(flat, z, z, boost_eps).sinv.reshape(a.shape)


def build_preconditioner(
    bt: BlockTridiag,
    variant: str = "C",
    boost_eps: float = DEFAULT_BOOST,
    precond_dtype: torch.dtype = torch.float32,
    spike_mode: str = "ul",
    reduced_solver: str = "auto",
    fused: str | bool = "off",
) -> SaPPreconditioner:
    """Factor the SaP preconditioner from block-tridiagonal partitions.

    spike_mode:
      * "ul"   -- paper Sec. 2.1 fast path: V^(b) from the bottom of the LU
                  factors, W^(t) from a UL factorization (top only).
      * "full" -- compute the *entire* spikes by full solves (R = K
                  right-hand sides) and take the needed blocks.
      Variant "E" needs all four corner blocks, so it takes whole spikes
      unless the fused pass supplies them.

    reduced_solver (variant "E" only): "chain" (sequential btf/bts sweep
    over the (P-1)-interface chain), "bcr" (block cyclic reduction,
    O(log2 P) parallel levels), or "auto" ("bcr" from 8 interfaces on).

    fused (``"on"`` / ``"off"`` / ``"auto"``; bools accepted): run the
    factor AND spike-corner extraction as one fused pass; ``"auto"`` is
    fused on the card.  Applies to variants C/E with P > 1 under
    ``spike_mode="ul"``.
    """
    if variant not in ("C", "D", "E"):
        raise ValueError(f"unknown SaP variant {variant!r}")
    if spike_mode not in ("ul", "full"):
        raise ValueError(f"unknown spike_mode {spike_mode!r}")
    reduced_solver = (
        resolve_reduced_solver(reduced_solver, bt.p - 1)
        if variant == "E" and bt.p > 1
        else "none"
    )
    use_fused = (
        resolve_fused(fused, bt.d.device)
        and variant in ("C", "E")
        and spike_mode == "ul"
        and bt.p > 1
    )
    d, e, f, b_cpl, c_cpl = (
        x.to(precond_dtype) for x in (bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    )

    v_bot = w_top = rbar_inv = red_lu = red_bcr = None
    v_top = w_bot = None
    # the route the kernels take: the CUDA kernels for tensors on the card,
    # the plain versions otherwise (the JAX package's ``impl``)
    impl = "cuda" if d.is_cuda else "torch"
    # each stage is a span timed on the card (``device_s``) that waits for
    # nothing; the caller's ``factor`` span waits once, at its close
    dev = d.device
    if use_fused:
        with device_span("factor.fused", dev, p=bt.p, m=bt.m, k=bt.k, variant=variant,
                         impl=impl):
            fs = kops.fused_factor_spike(d, e, f, b_cpl, c_cpl, boost_eps)
            lu = fs.lu
            v_bot, w_top, v_top, w_bot = fs.v_bot, fs.w_top, fs.v_top, fs.w_bot
    else:
        with device_span("factor.lu", dev, p=bt.p, m=bt.m, k=bt.k, impl=impl):
            lu = kops.block_tridiag_factor(d, e, f, boost_eps)

    if variant in ("C", "E") and bt.p > 1:
        if not use_fused:
            with device_span("factor.spike", dev, variant=variant, mode=spike_mode):
                if variant == "C" and spike_mode == "ul":
                    # V_i^(b) = Sinv_i[M-1] @ B_i  for i = 0..P-2
                    v_bot = lu.sinv[..., :-1, -1, :, :] @ b_cpl
                    # W_{i+1}^(t) from the UL factorization of partitions 1..P-1
                    ul = kops.block_tridiag_factor(*flip_block_tridiag(d, e, f), boost_eps)
                    w_top = _flip_rows(ul.sinv[..., 1:, -1, :, :] @ _flip_rows(c_cpl))
                else:
                    # whole right spikes: A_i V_i = [0;..;B_i], keep corners
                    rhs_b = torch.zeros_like(d)
                    rhs_b[..., :-1, -1, :, :] = b_cpl
                    v_full = kops.block_tridiag_solve(lu, rhs_b)
                    v_bot, v_top = v_full[..., :-1, -1, :, :], v_full[..., :-1, 0, :, :]
                    # whole left spikes: A_{i+1} W_{i+1} = [C_{i+1};0;..]
                    rhs_c = torch.zeros_like(d)
                    rhs_c[..., 1:, 0, :, :] = c_cpl
                    w_full = kops.block_tridiag_solve(lu, rhs_c)
                    w_top, w_bot = w_full[..., 1:, 0, :, :], w_full[..., 1:, -1, :, :]
        if variant == "C":
            with device_span("factor.reduced", dev, solver="truncated"):
                eye = torch.eye(bt.k, dtype=d.dtype, device=d.device)
                rbar_inv = _block_inverse(eye - w_top @ v_bot, boost_eps)
        else:
            # exact reduced system: a (P-1)-long chain of 2K x 2K blocks,
            # factored by the sequential sweep or by block cyclic reduction
            with device_span("factor.reduced", dev, solver=reduced_solver):
                rd, re, rf = _reduced_interface_system(v_bot, v_top, w_top, w_bot)
                if reduced_solver == "bcr":
                    red_bcr = kops.bcr_factor(rd, re, rf, boost_eps)
                else:
                    red_lu = kops.block_tridiag_factor_chain(rd, re, rf, boost_eps)
    elif variant in ("C", "E"):
        variant = "D"  # single partition: coupled/exact == decoupled

    return SaPPreconditioner(
        variant=variant,
        lu=lu,
        b_cpl=b_cpl,
        c_cpl=c_cpl,
        v_bot=v_bot,
        w_top=w_top,
        rbar_inv=rbar_inv,
        red_lu=red_lu,
        red_bcr=red_bcr,
        p=bt.p,
        m=bt.m,
        k=bt.k,
        reduced_solver=reduced_solver,
        fused=use_fused,
    )
