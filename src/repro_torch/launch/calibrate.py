"""Micro-benchmark calibration of the roofline ceilings on the card.

The data sheet gives an H100's peaks at its full power limit; a card set
below it, or any real kernel, reaches less.  This module measures the
ceilings the port's bounds divide by:

  * ``measure_gemm_flops`` -- sustained float32 FLOP/s of an (n, n) @
    (n, n) matmul with TF32 off (the CUDA cores, the rate the solver
    kernels compute at);
  * ``measure_bf16_flops`` -- sustained bfloat16 FLOP/s of the same matmul
    on the tensor cores (the flash kernel's bound);
  * ``measure_stream_bw`` -- sustained memory bandwidth of STREAM "scale"
    (``y = 1.0001 x``) over an array far larger than the 50 MB L2,
    counting read plus write bytes;
  * ``measure_link_bw`` -- the all-reduce rate between two gloo ranks
    (buffer bytes over seconds), the path the sharded LM step's
    collectives take on a machine with one card: both ranks on the card,
    each buffer through a host copy.  It starts two processes; run it
    where that is wanted (``--link``), not by default.

Each is the median of CUDA-event timed repeats after a warm-up (host
clock on the CPU).  Run it on the card::

    python -m repro_torch.launch.calibrate

which prints the ceilings and the ``REPRO_PEAK_FLOPS`` / ``REPRO_HBM_BW``
lines that :func:`repro_torch.obs.cost.hardware_spec` reads.  Setting
``REPRO_CALIBRATE=1`` makes ``hardware_spec`` run this calibration
itself, once per process.  ``--device cpu`` measures the CPU instead.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from .roofline import HardwareSpec


def _median_seconds(fn, device: torch.device, repeats: int, warmup: int = 2) -> float:
    """Median seconds of ``fn()`` over ``repeats`` calls after ``warmup``:
    each call between two CUDA events on the card, by the host clock on
    the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _gemm_flops(n: int, dtype: torch.dtype, repeats: int, device) -> float:
    dev = resolve_device(device)
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=dev).to(dtype)
    b = torch.randn(n, n, generator=g, device=dev).to(dtype)
    out = torch.empty(n, n, device=dev, dtype=dtype)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sec = _median_seconds(lambda: torch.matmul(a, b, out=out), dev, repeats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return 2.0 * n**3 / sec


def measure_gemm_flops(n: int = 8192, repeats: int = 10, device=None) -> float:
    """Sustained float32 FLOP/s of an (n, n) @ (n, n) matmul, TF32 off
    (restored afterwards)."""
    return _gemm_flops(n, torch.float32, repeats, device)


def measure_bf16_flops(n: int = 8192, repeats: int = 10, device=None) -> float:
    """Sustained bfloat16 FLOP/s of an (n, n) @ (n, n) matmul."""
    return _gemm_flops(n, torch.bfloat16, repeats, device)


def measure_stream_bw(nbytes: int = 1 << 30, repeats: int = 10, device=None) -> float:
    """Sustained memory bandwidth (bytes/s) of STREAM "scale" over a
    float32 array of ``nbytes``: read + write, 2 x ``nbytes`` a pass."""
    dev = resolve_device(device)
    x = torch.ones(nbytes // 4, device=dev)
    y = torch.empty_like(x)
    sec = _median_seconds(lambda: torch.mul(x, 1.0001, out=y), dev, repeats)
    return 2.0 * x.numel() * 4 / sec


def _link_rank(nbytes: int, repeats: int, device) -> float:
    """One rank of :func:`measure_link_bw`: median seconds of an
    all-reduce of ``nbytes`` over the group, card buffers through host
    copies as :func:`repro_torch.core.distributed.all_reduce_axis` sends
    them."""
    import torch.distributed as dist

    dev = resolve_device(device)
    x = torch.ones(nbytes // 4, device=dev)

    def once():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        buf = x.cpu() if dev.type == "cuda" else x.clone()
        dist.all_reduce(buf)
        buf.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(2):
        once()
    times = []
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def measure_link_bw(nbytes: int = 64 << 20, repeats: int = 10, device=None) -> float:
    """Bytes/s of an all-reduce of ``nbytes`` between two gloo ranks on
    ``device`` (default: the card), each buffer through a host copy: the
    slower rank's median, host clock."""
    from .mesh import spawn_ranks

    dev = resolve_device(device)
    sec = max(spawn_ranks(_link_rank, 2, args=(nbytes, repeats, str(dev))))
    return nbytes / sec


def calibrate(gemm_n: int = 8192, stream_bytes: int = 1 << 30, repeats: int = 10,
              device=None) -> HardwareSpec:
    """Measure the three ceilings on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return HardwareSpec(
        name=f"{dev.type}-calibrated",
        peak_flops=measure_gemm_flops(gemm_n, repeats, dev),
        hbm_bw=measure_stream_bw(stream_bytes, repeats, dev),
        peak_bf16_flops=measure_bf16_flops(gemm_n, repeats, dev),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gemm-n", type=int, default=8192, help="square matmul size (default 8192)")
    ap.add_argument("--stream-mib", type=int, default=1024,
                    help="stream array size in MiB (default 1024)")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--link", action="store_true",
                    help="also the gloo all-reduce rate between two ranks (64 MiB)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = calibrate(args.gemm_n, args.stream_mib << 20, args.repeats, dev)
    if args.link:
        link = measure_link_bw(device=dev)
        print(f"link_bw        : {link:.4e} bytes/s "
              f"({link / 1e9:.3f} GB/s gloo all-reduce, 2 ranks, host copies)")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device         : {name}")
    print(f"peak_flops     : {spec.peak_flops:.4e} flop/s "
          f"({spec.peak_flops / 1e12:.2f} TFLOP/s float32 gemm, TF32 off)")
    print(f"peak_bf16_flops: {spec.peak_bf16_flops:.4e} flop/s "
          f"({spec.peak_bf16_flops / 1e12:.2f} TFLOP/s bfloat16 gemm)")
    print(f"hbm_bw         : {spec.hbm_bw:.4e} bytes/s "
          f"({spec.hbm_bw / 1e12:.3f} TB/s stream scale)")
    print("# env overrides for repro_torch.obs.cost.hardware_spec:")
    print(f"export REPRO_PEAK_FLOPS={spec.peak_flops:.4e}")
    print(f"export REPRO_HBM_BW={spec.hbm_bw:.4e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
