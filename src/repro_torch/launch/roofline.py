"""The two roofline ceilings of a device: peak FLOP/s and memory bandwidth.

A stage's roofline time is ``max(flops / peak_flops, bytes / hbm_bw)``:
the least time the device could take for that work.  This module is the
part of the JAX package's ``repro.launch.roofline`` that the cost model
(:mod:`repro_torch.obs.cost`) needs -- :class:`HardwareSpec`,
:data:`BACKEND_SPECS` and :func:`backend_spec` -- keyed by torch device
type, and the model zoo's analytic useful FLOPs (:func:`active_params`,
:func:`model_flops`), and :class:`Roofline` / :func:`analyze`, the
per-device compute, memory and collective terms of a sharded train step.
The port has no HLO to parse: :func:`step_stats` counts a step's work as
it runs (FLOPs by ``torch.utils.flop_counter``, collective bytes from the
collective wrappers' counters, HBM bytes from a stated count).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak rates of one device, the two roofline ceilings.

    ``peak_flops`` (float32 FLOP/s outside the tensor cores, the rate the
    solver kernels compute at) and ``hbm_bw`` (bytes/s) bound the compute
    and memory terms of a stage's roofline time.  ``peak_bf16_flops`` is
    the tensor cores' bfloat16 rate where it was measured (the flash
    kernel's bound), else None.  Override per machine with
    ``REPRO_PEAK_FLOPS`` / ``REPRO_HBM_BW``, or set ``REPRO_CALIBRATE=1``
    to have :func:`repro_torch.obs.cost.hardware_spec` measure them once
    per process (:mod:`repro_torch.launch.calibrate`).
    """

    name: str
    peak_flops: float  # flops/s
    hbm_bw: float  # bytes/s
    peak_bf16_flops: Optional[float] = None  # flops/s, tensor cores
    # bytes/s of a collective's buffer between two ranks (analyze's
    # collective term), where known
    link_bw: Optional[float] = None


BACKEND_SPECS = {
    # Measured on an "NVIDIA H100 80GB HBM3, 700.00 W" card by
    # ``python -m repro_torch.launch.calibrate`` (each the median of 10
    # CUDA-event timed repeats after a warm-up; the entry is the middle
    # of three runs, which spanned 51.60-51.79 TFLOP/s, 2.895-2.962 TB/s
    # and 771.7-791.2 TFLOP/s): an 8192^3 float32 GEMM with TF32 off, STREAM
    # "scale" over 1 GiB (read + write bytes) and an 8192^3 bfloat16 GEMM.
    # The data sheet's figures for the SXM part are 67 TFLOP/s, 3.35 TB/s
    # and 989 TFLOP/s.  link_bw: ``measure_link_bw`` on the same card model
    # and limit, the middle of three runs (0.550-0.701 GB/s): a gloo
    # all-reduce of 64 MiB between two ranks on the one card, each buffer
    # through a host copy -- the path of the sharded LM step's collectives
    # on a one-card machine, not NVLink's.
    "cuda": HardwareSpec("cuda-h100-calibrated", 5.1738e13, 2.9599e12, 7.8767e14, 6.1433e8),
    # The JAX package's cpu entry, measured by its own calibrate module on
    # a single-core CI runner (a jitted 1024^2 float32 GEMM, a 256 MiB
    # stream pass): ~125 GFLOP/s, ~4.5 GB/s.  An order of magnitude for
    # the plain versions on a CPU; re-measure with
    # ``python -m repro_torch.launch.calibrate --device cpu``.
    "cpu": HardwareSpec("cpu-calibrated", 1.25e11, 4.5e9),
}


# The data sheet's peaks of one H100 SXM at its full 700 W power limit
# (NVIDIA; dense rates, no sparsity): 67 TFLOP/s float32 outside the tensor
# cores, 3.35 TB/s of HBM3, 989 TFLOP/s bfloat16 on the tensor cores, and
# NVLink 4's 450 GB/s a direction (900 GB/s both ways) between two cards.
# Not measured: the ceilings no card of the part can beat, so a kernel's
# time never reads under a bound taken against them.
H100_DATASHEET = HardwareSpec("cuda-h100-datasheet", 67e12, 3.35e12, 989e12, 450e9)
# The H100 SXM5's special-function (exponential) rate, 3.9 T/s, as the
# FlashAttention-3 paper gives it beside the 989 TFLOP/s (Shah et al.,
# 2024, "FlashAttention-3: Fast and Accurate Attention with Asynchrony and
# Low-precision", Sec. 3.1).  The calibration does not measure it.
H100_DATASHEET_SFU_S = 3.9e12


def backend_spec(device_type: str) -> HardwareSpec:
    """Peak rates by torch device type ("cuda" | "cpu"; others: the cpu entry)."""
    return BACKEND_SPECS.get(device_type, BACKEND_SPECS["cpu"])


# ---------------------------------------------------------------------------
# MODEL_FLOPS (analytic "useful flops") per shape kind
# ---------------------------------------------------------------------------


def active_params(cfg) -> float:
    """Parameters touched per token (MoE: routed top-k + shared experts
    only; hybrid: the shared attention block is touched once per
    application, i.e. n_layers/attn_every times)."""
    total = cfg.params_count()
    if cfg.n_experts:
        mlp_one = cfg.d_model * cfg.d_ff * (3 if cfg.gated_mlp else 2)
        n_blocks = cfg.n_layers
        routed_all = cfg.n_experts * mlp_one * n_blocks
        routed_active = cfg.top_k * mlp_one * n_blocks
        return total - routed_all + routed_active
    if cfg.family == "hybrid" and cfg.attn_every:
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + hd * cfg.n_heads * d
        shared = attn + 3 * d * f
        n_apps = cfg.n_layers // cfg.attn_every
        return total + (n_apps - 1) * shared
    return total


def model_flops(cfg, shape) -> float:
    """6 N D for training, 2 N D for inference forward passes, N the
    active parameters and D the tokens of ``shape`` (a
    :class:`repro_torch.models.api.ShapeSpec`)."""
    n_act = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens


# ---------------------------------------------------------------------------
# The roofline of a sharded step (per device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    """The JAX package's roofline record, per device."""

    flops: float  # per-device flops
    bytes_accessed: float  # per-device HBM bytes
    coll_bytes: float  # per-device collective bytes
    coll_detail: dict
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(stats: dict, chips: int, model_flops_global: float,
            hw: Optional[HardwareSpec] = None, bf16: bool = True) -> Roofline:
    """Roofline terms of one device's share of a step: ``stats`` holds its
    ``flops``, ``hbm_bytes``, ``coll_bytes`` and ``coll_detail`` (from
    :func:`step_stats`); ``hw`` its ceilings (default: the card's
    calibrated ones) -- the bfloat16 rate for the compute term with
    ``bf16`` where it is known, else the float32 one, and ``link_bw`` for
    the collective term.  The bottleneck is the largest term."""
    hw = hw or backend_spec("cuda")
    flops = float(stats.get("flops", 0.0))
    bytes_acc = float(stats.get("hbm_bytes", 0.0))
    cbytes = float(stats.get("coll_bytes", 0.0))
    rate = hw.peak_bf16_flops if bf16 and hw.peak_bf16_flops else hw.peak_flops
    if cbytes and not hw.link_bw:
        raise ValueError(f"{hw.name} has no link bandwidth for the collective term")
    compute_s = flops / rate
    memory_s = bytes_acc / hw.hbm_bw
    coll_s = cbytes / hw.link_bw if cbytes else 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf_per_dev = model_flops_global / chips
    return Roofline(
        flops=flops,
        bytes_accessed=bytes_acc,
        coll_bytes=cbytes,
        coll_detail=dict(stats.get("coll_detail", {})),
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops=model_flops_global,
        useful_ratio=mf_per_dev / flops if flops > 0 else 0.0,
    )


def step_stats(run: Callable[[], Any], param_bytes: int, opt_bytes: int) -> tuple[Any, dict]:
    """Run ``run()`` (one rank's train step) once and count its work:
    (its result, {"flops", "hbm_bytes", "coll_bytes", "coll_detail",
    "saved_bytes"}).

    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total (the
      PyTorch operators; a hand-written kernel launched from a wrapper is
      not seen by it);
    * ``coll_bytes`` / ``coll_detail``: the buffers of the collectives over
      mesh axes, by kind and axis
      (:func:`repro_torch.core.distributed.comm_stats`);
    * ``hbm_bytes`` = 3 P + 2 G + 2 O + 2 A: the parameters (``param_bytes``,
      read forward and backward, written by the update), the float32
      gradients G = P (written, read), the optimizer state (``opt_bytes``,
      read and written) and the tensors autograd saves, A =
      ``saved_bytes`` (written forward, read backward), each counted as
      often as it is saved.
    """
    from torch.utils.flop_counter import FlopCounterMode

    from ..core.distributed import comm_stats, reset_comm_stats

    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    reset_comm_stats()
    with FlopCounterMode(display=False) as counter:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = run()
    detail = comm_stats()["by_axis"]
    grad_bytes = param_bytes
    stats = {
        "flops": float(counter.get_total_flops()),
        "coll_bytes": float(sum(v["bytes"] for v in detail.values())),
        "coll_detail": detail,
        "saved_bytes": float(saved[0]),
        "hbm_bytes": float(3 * param_bytes + 2 * grad_bytes + 2 * opt_bytes + 2 * saved[0]),
    }
    return out, stats
