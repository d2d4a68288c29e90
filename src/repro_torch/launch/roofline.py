"""The two roofline ceilings of a device: peak FLOP/s and memory bandwidth.

A stage's roofline time is ``max(flops / peak_flops, bytes / hbm_bw)``:
the least time the device could take for that work.  This module is the
part of the JAX package's ``repro.launch.roofline`` that the cost model
(:mod:`repro_torch.obs.cost`) needs -- :class:`HardwareSpec`,
:data:`BACKEND_SPECS` and :func:`backend_spec` -- keyed by torch device
type, and the model zoo's analytic useful FLOPs (:func:`active_params`,
:func:`model_flops`).  The HLO parsing, ``analyze`` and ``Roofline`` are
not here: they serve the distributed path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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


BACKEND_SPECS = {
    # Measured on an "NVIDIA H100 80GB HBM3, 700.00 W" card by
    # ``python -m repro_torch.launch.calibrate`` (each the median of 10
    # CUDA-event timed repeats after a warm-up; the entry is the middle
    # of three runs, which spanned 51.60-51.79 TFLOP/s, 2.895-2.962 TB/s
    # and 771.7-791.2 TFLOP/s): an 8192^3 float32 GEMM with TF32 off, STREAM
    # "scale" over 1 GiB (read + write bytes) and an 8192^3 bfloat16 GEMM.
    # The data sheet's figures for the SXM part are 67 TFLOP/s, 3.35 TB/s
    # and 989 TFLOP/s.
    "cuda": HardwareSpec("cuda-h100-calibrated", 5.1738e13, 2.9599e12, 7.8767e14),
    # The JAX package's cpu entry, measured by its own calibrate module on
    # a single-core CI runner (a jitted 1024^2 float32 GEMM, a 256 MiB
    # stream pass): ~125 GFLOP/s, ~4.5 GB/s.  An order of magnitude for
    # the plain versions on a CPU; re-measure with
    # ``python -m repro_torch.launch.calibrate --device cpu``.
    "cpu": HardwareSpec("cpu-calibrated", 1.25e11, 4.5e9),
}


# The data sheet's peaks of one H100 SXM at its full 700 W power limit
# (NVIDIA; dense rates, no sparsity): 67 TFLOP/s float32 outside the tensor
# cores, 3.35 TB/s of HBM3, 989 TFLOP/s bfloat16 on the tensor cores.  Not
# measured: the ceilings no card of the part can beat, so a kernel's time
# never reads under a bound taken against them.
H100_DATASHEET = HardwareSpec("cuda-h100-datasheet", 67e12, 3.35e12, 989e12)
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
