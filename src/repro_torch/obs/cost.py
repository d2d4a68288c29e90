"""Cost observatory: per-stage roofline accounting and device memory.

The tracer (:mod:`repro_torch.obs.trace`) answers *where the seconds
went*; this module answers *what those seconds should have been*.  Each
solver stage -- the factor, one Krylov solve, the raw btf / bts / BCR
kernels -- gets a :class:`StageCost`: flops, device-memory bytes,
arithmetic intensity, and the roofline-predicted seconds ``max(flops /
peak_flops, bytes / hbm_bw)`` under the device's
:class:`~repro_torch.launch.roofline.HardwareSpec` (on the card the
calibrated H100 ceilings).  Dividing the prediction by a measured time
gives the achieved-vs-roofline fraction.

The JAX package's ``repro.obs.cost`` reads its counts off the compiled
XLA executables (``cost_analysis()`` and a loop-aware HLO walk).  The
port has no HLO: its counts are analytic, the ``*_work`` functions of
:mod:`repro_torch.kernels.ops` (each input read once, each output written
once) summed over what the port launches for a bucket on a device.  The
XLA compile telemetry (``COMPILES``, ``timed_compile``,
``install_compile_listener``) has no counterpart: nothing is compiled
per shape here.

A Krylov cost bakes in ``maxiter`` sweeps (``loop_iters``), as the JAX
package's loop-aware walk does; :meth:`StageCost.per_iteration` divides
it back down so callers can scale by the sweeps a solve actually ran.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from ..launch.roofline import HardwareSpec, backend_spec

__all__ = [
    "StageCost",
    "device_memory_bytes",
    "hardware_spec",
    "solver_stage_costs",
    "stage_cost",
]


def _device_type(device=None) -> str:
    """"cuda" or "cpu": the named device's type, or where the port's entry
    points run by default (the card if there is one)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


# ---------------------------------------------------------------------------
# Hardware spec resolution
# ---------------------------------------------------------------------------

# Results of the REPRO_CALIBRATE=1 micro-benchmark, by device type; measured
# once per process the first time hardware_spec() needs one.
_CALIBRATED: Dict[str, HardwareSpec] = {}
_CALIBRATED_LOCK = threading.Lock()


def hardware_spec(device=None) -> HardwareSpec:
    """The device's peak rates, with env overrides.

    ``REPRO_PEAK_FLOPS`` / ``REPRO_HBM_BW`` (floats, flops/s and bytes/s)
    override the per-device defaults in
    :data:`repro_torch.launch.roofline.BACKEND_SPECS`.  ``REPRO_CALIBRATE=1``
    instead *measures* this machine's ceilings once per process via
    :func:`repro_torch.launch.calibrate.calibrate` (a few seconds of GEMM
    and stream on the card; a 1024^2 GEMM and a 256 MiB stream on the
    CPU); explicit env numbers still win over the measurement.
    """
    kind = _device_type(device)
    spec = backend_spec(kind)
    if os.environ.get("REPRO_CALIBRATE") == "1":
        with _CALIBRATED_LOCK:
            if kind not in _CALIBRATED:
                from ..launch.calibrate import calibrate

                sizes = {} if kind == "cuda" else {"gemm_n": 1024, "stream_bytes": 1 << 28}
                _CALIBRATED[kind] = calibrate(device=kind, **sizes)
            spec = _CALIBRATED[kind]
    pf = os.environ.get("REPRO_PEAK_FLOPS")
    bw = os.environ.get("REPRO_HBM_BW")
    if pf or bw:
        spec = dataclasses.replace(
            spec,
            name=spec.name + "+env",
            peak_flops=float(pf) if pf else spec.peak_flops,
            hbm_bw=float(bw) if bw else spec.hbm_bw,
        )
    return spec


# ---------------------------------------------------------------------------
# Device memory
# ---------------------------------------------------------------------------


def device_memory_bytes(device=None) -> int:
    """Bytes the card's allocator holds for tensors
    (``torch.cuda.memory_allocated``); 0 on the CPU, where nothing lives on
    a card.  The JAX package sums ``jax.live_arrays()`` on the CPU instead;
    here a CPU run reports no device footprint."""
    if _device_type(device) != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(device))


# ---------------------------------------------------------------------------
# Stage cost records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Roofline accounting of one solver stage.

    ``flops`` / ``hbm_bytes`` are analytic counts of what the port launches
    (:mod:`repro_torch.kernels.ops`' ``*_work``); the JAX package's
    ``xla_flops`` / ``xla_bytes`` (``compiled.cost_analysis()``) have no
    counterpart.  ``loop_iters`` marks costs that bake a loop trip count
    in (Krylov: ``maxiter`` sweeps) -- :meth:`per_iteration` removes it.
    """

    stage: str
    flops: float
    hbm_bytes: float
    intensity: float  # flops / hbm_bytes
    compute_s: float
    memory_s: float
    roofline_s: float  # max(compute_s, memory_s)
    bottleneck: str  # "compute" | "memory"
    hw: str
    loop_iters: Optional[int] = None

    def scale(self, factor: float) -> "StageCost":
        """Linear rescale (e.g. per-batch-element cost x batch size)."""
        return dataclasses.replace(
            self,
            flops=self.flops * factor,
            hbm_bytes=self.hbm_bytes * factor,
            compute_s=self.compute_s * factor,
            memory_s=self.memory_s * factor,
            roofline_s=self.roofline_s * factor,
        )

    def per_iteration(self) -> "StageCost":
        """Cost of ONE loop sweep for stages with a baked-in trip count."""
        if not self.loop_iters or self.loop_iters <= 1:
            return self
        out = self.scale(1.0 / self.loop_iters)
        return dataclasses.replace(out, loop_iters=None)

    def achieved_fraction(self, measured_s: float) -> float:
        """roofline_s / measured_s: 1.0 = running at the hardware ceiling."""
        if measured_s <= 0.0:
            return float("nan")
        return self.roofline_s / measured_s

    def to_dict(self, measured_s: Optional[float] = None) -> dict:
        """JSON-ready record; includes roofline_frac when measured_s given."""
        d = {
            "stage": self.stage,
            "flops": float(self.flops),
            "hbm_bytes": float(self.hbm_bytes),
            "intensity": round(self.intensity, 4),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "roofline_s": self.roofline_s,
            "bottleneck": self.bottleneck,
            "hw": self.hw,
        }
        if self.loop_iters is not None:
            d["loop_iters"] = int(self.loop_iters)
        if measured_s is not None:
            d["measured_s"] = measured_s
            d["roofline_frac"] = round(self.achieved_fraction(measured_s), 6)
        return d


def stage_cost(
    stage: str,
    flops: float,
    hbm_bytes: float,
    hw: Optional[HardwareSpec] = None,
    loop_iters: Optional[int] = None,
) -> StageCost:
    """Roofline-account ``flops`` and ``hbm_bytes`` under ``hw`` (default:
    :func:`hardware_spec`)."""
    hw = hw or hardware_spec()
    compute_s = flops / hw.peak_flops
    memory_s = hbm_bytes / hw.hbm_bw
    return StageCost(
        stage=stage,
        flops=float(flops),
        hbm_bytes=float(hbm_bytes),
        intensity=flops / hbm_bytes if hbm_bytes > 0 else 0.0,
        compute_s=compute_s,
        memory_s=memory_s,
        roofline_s=max(compute_s, memory_s),
        bottleneck="compute" if compute_s >= memory_s else "memory",
        hw=hw.name,
        loop_iters=loop_iters,
    )


# ---------------------------------------------------------------------------
# Solver stage costs (per bucket shape)
# ---------------------------------------------------------------------------
#
# The counts below follow the code, stage by stage:
#   factor (core/sap.py:factor, core/spike.py:build_preconditioner): the
#     split (the band read once, the d, e, f blocks written), then on the
#     card ("auto" = fused) the fused pass, on the CPU btf, the UL btf and
#     the spike products (C) or two whole-spike bts solves (E); then the
#     reduced system: C's I - W V and its inverse (btf on one-block chains),
#     E's interface chain (assembled, then BCR's inv_odd + reduce, or btf
#     over the chain);
#   krylov (core/krylov.py:_bicgstab2_block): a sweep is 4 band matvecs and
#     4 preconditioner applies, 12 inner products or norms, 9 two-term and
#     3 three-term vector updates and 9 masked selects of the (x, r, u)
#     state: 85 passes over an (N, R) vector and 54 flops an element; the
#     solve adds one matvec and two applies before the loop and one matvec
#     (the true residual) after it.  An apply is bts (D), two bts and the
#     truncated correction (C: five K x K products an interface), or two
#     bts and the exact reduced solve (E: BCR's rhs_reduce + backsub, or
#     bts over the chain) plus the two coupling products.

_SOLVER_COSTS: Dict[tuple, Dict[str, StageCost]] = {}
_SOLVER_COSTS_LOCK = threading.Lock()

_SWEEP_VECTOR_PASSES = 85
_SWEEP_VECTOR_FLOPS = 54


def _add(*works: Tuple[float, float]) -> Tuple[float, float]:
    return sum(w[0] for w in works), sum(w[1] for w in works)


def _times(n: float, work: Tuple[float, float]) -> Tuple[float, float]:
    return n * work[0], n * work[1]


def _products(count: int, k: int, r: int) -> Tuple[float, float]:
    """``count`` K x K block times K x R products: each reads the block and
    the K x R operand, writes the K x R result (float32)."""
    return count * 2.0 * k * k * r, count * 4.0 * (k * k + 2 * k * r)


def _factor_work(nb, kb, p, m, variant, fused, reduced) -> Tuple[float, float]:
    from ..kernels import ops as kops

    split = (0.0, 4.0 * nb * (2 * kb + 1) + 3 * 4.0 * p * m * kb * kb)
    if variant == "D" or p == 1:
        return _add(split, kops.btf_work(p, m, kb))
    if fused:
        lu_spikes = kops.fused_work(p, m, kb)
    elif variant == "C":
        lu_spikes = _add(kops.btf_work(p, m, kb), kops.btf_work(p, m, kb),
                         _products(2 * (p - 1), kb, kb))
    else:  # whole spikes: two solves with K right-hand sides
        lu_spikes = _add(kops.btf_work(p, m, kb), _times(2, kops.bts_work(p, m, kb, kb)))
    if variant == "C":
        reduced_work = _add(_products(p - 1, kb, kb), kops.btf_work(p - 1, 1, kb))
    else:
        k2 = 2 * kb
        assemble = (0.0, 4.0 * (p - 1) * (3 * k2 * k2 + 4 * kb * kb))
        if reduced == "bcr":
            bw = kops.bcr_work(p - 1, k2, 1)
            chain = _add(bw["inv_odd"], bw["reduce"])
        else:
            chain = kops.btf_work(1, p - 1, k2)
        reduced_work = _add(assemble, chain)
    return _add(split, lu_spikes, reduced_work)


def _apply_work(p, m, kb, r, variant, reduced) -> Tuple[float, float]:
    from ..kernels import ops as kops

    sweep = kops.bts_work(p, m, kb, r)
    if variant == "D" or p == 1:
        return sweep
    if variant == "C":
        return _add(_times(2, sweep), _products(5 * (p - 1), kb, r))
    k2 = 2 * kb
    if reduced == "bcr":
        bw = kops.bcr_work(p - 1, k2, r)
        chain = _add(bw["rhs_reduce"], bw["backsub"])
    else:
        chain = kops.bts_work(1, p - 1, k2, r)
    return _add(_times(2, sweep), chain, _products(2 * (p - 1), kb, r))


def _matvec_work(nb, kb, r, elt) -> Tuple[float, float]:
    """A float32 band (N, 2K+1) times an (N, R) block of ``elt``-byte
    floats: 2 (2K+1) N R flops; the band and x read once, y written."""
    return 2.0 * (2 * kb + 1) * nb * r, 4.0 * nb * (2 * kb + 1) + 2.0 * elt * nb * r


def solver_stage_costs(
    bucket: Tuple[int, int, int],
    s: int = 1,
    opts=None,
    variant: Optional[str] = None,
    dtype=None,
    device=None,
) -> Dict[str, StageCost]:
    """Roofline costs of every solver stage for one bucket shape.

    ``bucket`` is the factored shape ``(N', K', P)`` (the engine's
    currency, from :func:`repro_torch.core.batched.bucket_shape`); ``s`` is
    the number of systems a call covers (the fold launches each kernel once
    for all of them, over S times the work).  ``dtype`` is the iteration
    dtype of the right-hand sides (default float32); the preconditioner is
    float32.  ``device`` (default: the card if there is one) decides what
    the factor launches -- fused on the card under ``fused_factor="auto"``.
    Returns a dict of :class:`StageCost` keyed by stage:

      * ``"factor"`` -- the split and the preconditioner's factor, as the
        port launches it on that device;
      * ``"krylov"`` -- one BiCGStab(2) solve of one right-hand side a
        system, ``maxiter`` sweeps baked in (``loop_iters``); use
        ``per_iteration()`` and scale by the sweeps a solve ran;
      * ``"btf"`` / ``"bts"`` -- the raw block-tridiagonal kernels at the
        bucket's (P, M, K') partition grid (bts at R = 1);
      * ``"bcr"`` -- block cyclic reduction's factor plus one R = 1 solve
        of the (P-1)-interface chain of 2K' blocks, when the variant is
        ``"E"`` with P > 1.

    Results are cached per (bucket, s, variant, the factor-relevant
    options, maxiter, dtype, device type, spec); repeated calls cost a
    dict lookup.
    """
    from ..core.banded import padded_partition_size
    from ..core.cyclic_reduction import resolve_reduced_solver
    from ..core.sap import SaPOptions, resolve_solver
    from ..core.spike import resolve_fused

    nb, kb, p = bucket
    opts = opts or SaPOptions(p=p)
    if variant is None:
        variant = opts.variant if opts.variant != "auto" else "C"
    dtype = dtype or torch.float32
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    dev_type = _device_type(device)
    hw = hardware_spec(dev_type)
    key = (
        tuple(bucket), s, variant, opts.reduced_solver, opts.fused_factor, opts.precond_dtype,
        opts.maxiter, resolve_solver(opts.solver, opts.use_cg), str(dtype), dev_type, hw,
    )
    with _SOLVER_COSTS_LOCK:
        hit = _SOLVER_COSTS.get(key)
    if hit is not None:
        return hit

    from ..kernels import ops as kops

    m = padded_partition_size(nb, p, kb) // kb
    fused = resolve_fused(opts.fused_factor, torch.device(dev_type)) and variant in ("C", "E")
    reduced = (resolve_reduced_solver(opts.reduced_solver, p - 1)
               if variant == "E" and p > 1 else None)
    elt = torch.empty((), dtype=dtype).element_size()

    costs: Dict[str, StageCost] = {}
    costs["factor"] = stage_cost(
        "factor", *_times(s, _factor_work(nb, kb, p, m, variant, fused, reduced)), hw=hw)
    step = _add(_matvec_work(nb, kb, 1, elt), _apply_work(p, m, kb, 1, variant, reduced))
    vectors = (_SWEEP_VECTOR_FLOPS * nb, _SWEEP_VECTOR_PASSES * elt * nb)
    sweep = _add(_times(4, step), vectors)
    outside = _add(_times(2, _matvec_work(nb, kb, 1, elt)),
                   _times(2, _apply_work(p, m, kb, 1, variant, reduced)))
    costs["krylov"] = stage_cost(
        "krylov", *_times(s, _add(_times(opts.maxiter, sweep), outside)), hw=hw,
        loop_iters=opts.maxiter)
    costs["btf"] = stage_cost("btf", *_times(s, kops.btf_work(p, m, kb)), hw=hw)
    costs["bts"] = stage_cost("bts", *_times(s, kops.bts_work(p, m, kb, 1)), hw=hw)
    if variant == "E" and p > 1:
        bw = kops.bcr_work(p - 1, 2 * kb, 1)
        costs["bcr"] = stage_cost("bcr", *_times(s, _add(*bw.values())), hw=hw)

    with _SOLVER_COSTS_LOCK:
        _SOLVER_COSTS.setdefault(key, costs)
        return _SOLVER_COSTS[key]
