#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense-banded SaP path on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX or
of the JAX package.  Phases, each printing one JSON line:

1. device and toolchain;
2. build: compiles the CUDA kernels of ``src/repro_torch/kernels/csrc``;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes (P=64, M=16, K=200), at the SaP-E reduced chain's
   (P=1, M=7, K=400) and at edge cases (M=1, K=37, K=256);
4. the slice at full size: N=200,000, K=200 banded systems (paper Table
   4.1/4.2 setting), float32 band storage and preconditioner, float64
   iteration, tol=1e-8, through ``factor(plan_banded(...)).solve`` for the
   variants D, C (fused and not), E and ``solve_many``, with every kernel
   wrapper's launch count;
5. timing of each kernel beside its plain version, with CUDA events.

Then the kernel summary line, the card's ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
N, K = 200_000, 200
TOL, MAXITER = 1e-8, 200
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 FMA rate
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Kernel against plain version, both float32 on the card: the largest
# difference at most this fraction of the largest plain value.  The same
# recurrences in float32 with the sums of every K x K product taken in
# another order; rounding compounds over the M block rows.
KERNEL_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(kernel, plain) -> tuple[float, float]:
    """(max abs difference, max abs difference / max abs plain value)."""
    diff = float((kernel.double() - plain.double()).abs().max())
    return diff, diff / max(float(plain.double().abs().max()), 1e-30)


def check_close(what: str, kernel, plain) -> float:
    import torch

    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err, rel = rel_err(kernel, plain)
    if rel > KERNEL_RTOL:
        raise AssertionError(f"{what}: max abs err {err:.3e} = {rel:.3e} of max > {KERNEL_RTOL}")
    return err


def btf_work(p: int, m: int, k: int) -> tuple[float, float]:
    """(flops, bytes) a block-tridiagonal LU of P chains of M K x K blocks
    must do.  Row 0 only inverts (2K^3); rows 1..M-1 each form L_j (2K^3),
    S_j = D_j - L_j F_{j-1} (2K^3 + K^2) and invert S_j (2K^3).  Reads every
    D, E_1..E_{M-1} and F_0..F_{M-2}; writes sinv and l."""
    flops = p * ((6 * m - 4) * k**3 + (m - 1) * k**2)
    return float(flops), 4.0 * p * k * k * ((3 * m - 2) + 2 * m)


def bts_work(p: int, m: int, k: int, r: int) -> tuple[float, float]:
    """(flops, bytes) of both sweeps for R right-hand sides: M-1 forward
    products, sinv_{M-1} y, then F_j x_{j+1} and sinv_j (...) for j < M-1,
    each 2K^2 R flops.  Reads sinv, l_1..l_{M-1}, f_0..f_{M-2} and b;
    writes x."""
    flops = p * ((6 * m - 4) * k * k * r + 2 * (m - 1) * k * r)
    return float(flops), 4.0 * p * ((3 * m - 2) * k * k + 2 * m * k * r)


def fused_work(p: int, m: int, k: int) -> tuple[float, float]:
    """(flops, bytes) of the fused pass: the LU and the UL recurrence (btf's
    work each), the two spike carries (M-1 products each) and the four
    corner products.  Reads the chain blocks btf reads plus bq and cq;
    writes sinv, l and the four K x K corners."""
    flops = p * ((16 * m - 4) * k**3 + 2 * (m - 1) * k**2)
    return float(flops), 4.0 * p * k * k * ((3 * m - 2) + 2 * m + 2 + 4)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, timed by CUDA events."""
    import torch

    fn()  # warm-up
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port package is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.core import (
        SaPOptions,
        band_matvec,
        band_to_block_tridiag,
        factor,
        plan_banded,
        random_banded,
    )
    from repro_torch.core import block_lu as bl
    from repro_torch.core.spike import _reduced_interface_system
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.btf import btf
    from repro_torch.kernels.bts import bts
    from repro_torch.kernels.fused_spike import fused_factor_spike

    dev = torch.device("cuda")
    smi = nvidia_smi()

    # ---- 1. device and toolchain -------------------------------------------
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True)
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    emit({
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_v.stdout.strip().splitlines()[-1],
        "triton": triton_v,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    })

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "sources": list(build.SOURCES), "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    # ---- 3. kernels against plain versions on the card ----------------------
    band_d1 = torch.tensor(random_banded(N, K, 1.0, seed=SEED).astype(np.float32), device=dev)
    bt = band_to_block_tridiag(band_d1, K, 64)
    assert (bt.p, bt.m, bt.k) == (64, 16, 200)
    errs: dict[str, float] = {}

    def check_kernels(tag, d, e, f, b_cpl, c_cpl, rs):
        sinv, l = btf(d, e, f)
        ref = bl.btf_ref(d, e, f)
        errs[f"btf{tag}"] = max(check_close(f"btf{tag} sinv", sinv, ref.sinv),
                                check_close(f"btf{tag} l", l, ref.l))
        g = torch.Generator(device=dev).manual_seed(SEED)
        for r in rs:
            rhs = torch.randn(d.shape[:3] + (r,), generator=g, device=dev)
            errs[f"bts{tag}_r{r}"] = check_close(
                f"bts{tag} r={r}", bts(ref.sinv, ref.l, f, rhs), bl.bts_ref(ref, rhs)
            )
        if b_cpl is not None:
            bq, cq = bl.pad_couplings(b_cpl, c_cpl, d.shape[0])
            out = fused_factor_spike(d, e, f, bq, cq)
            want = bl.fused_factor_spike_padded_ref(d, e, f, bq, cq)
            errs[f"fused{tag}"] = max(
                check_close(f"fused{tag} {nm}", o, w)
                for nm, o, w in zip(("sinv", "l", "vb", "vt", "wt", "wb"), out, want)
            )

    check_kernels("", bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl, (1, 4, K))
    main_path_errs = dict(errs)
    # the SaP-E reduced chain: (P-1) = 7 interfaces of 2K x 2K blocks, built
    # from the spike corners of an 8-partition split of the same band
    bt8 = band_to_block_tridiag(band_d1, K, 8)
    fs8 = ops.fused_factor_spike(bt8.d, bt8.e, bt8.f, bt8.b_cpl, bt8.c_cpl)
    rd, re, rf = _reduced_interface_system(fs8.v_bot, fs8.v_top, fs8.w_top, fs8.w_bot)
    del bt8, fs8
    check_kernels("_chain", rd[None], re[None], rf[None], None, None, (1, 4))
    # edge cases: a single block row with an all-padding last partition; K
    # not a power of two with a partly padded last partition; K = 256, whose
    # elimination block no longer fits in shared memory (btf and the fused
    # pass then keep it, and the fused carries, in device memory)
    edge = {"_m1": (15, 5, 4), "_k37": (259, 37, 3), "_k256": (1400, 256, 2)}
    for tag, (n, k, p) in edge.items():
        small = torch.tensor(random_banded(n, k, 1.0, seed=SEED).astype(np.float32), device=dev)
        sbt = band_to_block_tridiag(small, k, p)
        check_kernels(tag, sbt.d, sbt.e, sbt.f, sbt.b_cpl, sbt.c_cpl, (1, 4, k))
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "rtol_normwise": KERNEL_RTOL, "max_abs_err": errs})

    # ---- 4. the slice at full size -------------------------------------------
    rng = np.random.default_rng(SEED)
    xstar = torch.tensor(rng.normal(size=N), device=dev)
    band_d05 = torch.tensor(random_banded(N, K, 0.5, seed=SEED).astype(np.float32), device=dev)
    systems = {}
    for name, band in (("d1.0", band_d1), ("d0.5", band_d05)):
        b64 = band_matvec(band.double(), xstar)
        systems[name] = (band, b64)
    wrappers = {"btf": btf, "bts": bts, "fused_factor_spike": fused_factor_spike}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {nm: w.launches for nm, w in wrappers.items()}

    runs = [
        # name, system, options, R, kernels the path must launch
        ("D", "d1.0", dict(p=64, variant="D"), 0, ("btf", "bts")),
        ("C", "d1.0", dict(p=64, variant="C"), 0, ("fused_factor_spike", "bts", "btf")),
        ("C_unfused", "d1.0", dict(p=64, variant="C", fused_factor="off"), 0, ("btf", "bts")),
        ("E", "d0.5", dict(p=8, variant="E"), 0, ("fused_factor_spike", "btf", "bts")),
        ("C_many", "d1.0", dict(p=64, variant="C"), 4, ("fused_factor_spike", "bts", "btf")),
    ]
    totals = dict.fromkeys(wrappers, 0)
    for name, sysname, kw, nrhs, must in runs:
        band, b64 = systems[sysname]
        if nrhs:
            scale = torch.arange(1, nrhs + 1, device=dev, dtype=torch.float64)
            rhs, want_x = b64[:, None] * scale, xstar[:, None] * scale
        else:
            rhs, want_x = b64, xstar
        opts = SaPOptions(tol=TOL, maxiter=MAXITER, precond_dtype="float32", **kw)
        # Each stage runs twice: the first call also pays one-time costs
        # (lazy loading of torch's CUDA kernels); the second is reported as
        # the stage's time.  Launch counts are those of the first call.
        first = {}
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for attempt in range(2):
            t0 = time.perf_counter()
            fac = factor(plan_banded(band, opts))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if attempt == 0:
                factor_counts = counts()
            res = fac.solve_many(rhs) if nrhs else fac.solve(rhs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if attempt == 0:
                solve_counts = {nm: c - factor_counts[nm] for nm, c in counts().items()}
                first = {"factor_ms_first_call": (t1 - t0) * 1e3,
                         "solve_ms_first_call": (t2 - t1) * 1e3}
                peak = torch.cuda.max_memory_allocated()
                del fac, res
        x = res.x
        a64 = band.double()
        resid = (rhs - band_matvec(a64, x)).norm(dim=0) / rhs.norm(dim=0)
        fwd = (x - want_x).norm(dim=0) / want_x.norm(dim=0)
        its = res.iterations.flatten().tolist()
        line = {
            "phase": "slice", "run": name, "n": N, "k": K, "system": sysname,
            "variant": fac.variant, "p": fac.p, "fused": fac.pc.fused,
            "reduced_solver": fac.pc.reduced_solver, "nrhs": max(nrhs, 1),
            "iterations": its, "true_resnorm_f64": resid.flatten().tolist(),
            "forward_error": fwd.flatten().tolist(),
            "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3, **first,
            "peak_mem_bytes": peak,
            "launches_factor": factor_counts, "launches_solve": solve_counts,
        }
        emit(line)
        for nm in wrappers:
            totals[nm] += factor_counts[nm] + solve_counts[nm]
        if not bool(torch.isfinite(x).all()) or x.shape != want_x.shape:
            raise AssertionError(f"slice {name}: bad solution")
        if float(resid.max()) > 1e-6:
            raise AssertionError(f"slice {name}: true_resnorm {resid.tolist()} > 1e-6")
        for nm in must:
            if factor_counts[nm] + solve_counts[nm] == 0:
                raise AssertionError(f"slice {name}: kernel {nm} was never launched")
        del fac, res, x
    del systems, band_d05

    # ---- 5. timing at the main path's shapes ---------------------------------
    p, m, k = bt.p, bt.m, bt.k
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    rhs1 = torch.randn((p, m, k, 1), device=dev)
    bq, cq = bl.pad_couplings(bt.b_cpl, bt.c_cpl, p)
    specs = {
        "btf": dict(
            source="src/repro_torch/kernels/csrc/btf.cu",
            replaces="src/repro/kernels/btf.py:40",
            kernel=lambda: btf(bt.d, bt.e, bt.f),
            plain=lambda: bl.btf_ref(bt.d, bt.e, bt.f),
            work=btf_work(p, m, k), reps=10, plain_reps=1, err=main_path_errs["btf"],
        ),
        "bts": dict(
            source="src/repro_torch/kernels/csrc/bts.cu",
            replaces="src/repro/kernels/bts.py:27",
            kernel=lambda: bts(ref.sinv, ref.l, bt.f, rhs1),
            plain=lambda: bl.bts_ref(ref, rhs1),
            work=bts_work(p, m, k, 1), reps=50, plain_reps=5, err=main_path_errs["bts_r1"],
        ),
        "fused_factor_spike": dict(
            source="src/repro_torch/kernels/csrc/fused_spike.cu",
            replaces="src/repro/kernels/fused_spike.py:47",
            kernel=lambda: fused_factor_spike(bt.d, bt.e, bt.f, bq, cq),
            plain=lambda: bl.fused_factor_spike_padded_ref(bt.d, bt.e, bt.f, bq, cq),
            work=fused_work(p, m, k), reps=5, plain_reps=1, err=main_path_errs["fused"],
        ),
    }
    summary = []
    for name, s in specs.items():
        saved = wrappers[name].launches
        ms = cuda_ms(s["kernel"], s["reps"])
        plain_ms = cuda_ms(s["plain"], s["plain_reps"])
        wrappers[name].launches = saved  # timing launches are not the path's
        flops, nbytes = s["work"]
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
        summary.append({
            "name": name, "route": "cuda", "source": s["source"], "replaces": s["replaces"],
            "launches": totals[name], "max_abs_err": s["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        emit({"phase": "timing", "kernel": name, "ms": ms, "plain_ms": plain_ms,
              "bytes": nbytes, "flops": flops, "shape": [p, m, k]})
    # host-orchestrated torch code of the path, timed for the record
    x64 = torch.randn(N, device=dev, dtype=torch.float64)
    emit({
        "phase": "timing", "torch_code": True,
        "band_matvec_f32band_f64x_ms": cuda_ms(lambda: band_matvec(band_d1, x64), 20),
        "band_to_block_tridiag_p64_ms": cuda_ms(lambda: band_to_block_tridiag(band_d1, K, 64), 5),
    })

    emit({"kernels": summary})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
