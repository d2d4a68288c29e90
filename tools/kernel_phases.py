#!/usr/bin/env python3
"""Where the time of the two redesigned kernels goes, on one NVIDIA card.

    python3 tools/kernel_phases.py

``ncu`` and ``nsys`` do not run on the machine with the card, so this
script measures by subtraction and by clock.  It compiles patched copies
of ``src/repro_torch/kernels/csrc/`` into ``build/kernel_phases/`` and
prints one JSON line each:

- ``flash``: the bfloat16 flash kernel at Minitron-8B's prefill shape (B=1,
  32 query heads over 8, T=4096, D=128, causal) as it stands, and with
  one phase removed -- the lo term of p.v, the p.v products, the q.k
  products, the next tile's loads, both products -- each by CUDA events
  (the copies compute wrong results; only their time is read);
- ``inv_phases``: the cluster inverse (``inv_cluster_kernel``) with
  ``clock64`` marks around its phases, read by thread 0 of the first CTA
  and summed over the panels, at 2K = 400 on clusters of 4 and 8 and at
  2K = 190 on one CTA; a phase's cycles include thread 0's waits at the
  barriers that end it;
- ``inv_routes``: the built library's two routes for 32 blocks of
  2K = 190, which fit one CTA's shared memory: the cluster kernel on one
  CTA (the route ``bcr_inv_cluster_size`` gives) against the one-block
  kernel, by CUDA events.

Then the card's ``nvidia-smi`` name and power limit.  Needs a CUDA card
and nvcc; the patches are exact string replacements and fail loudly when
a kernel source no longer matches them.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_phases"


def patched(text: str, *subs: tuple[str, str]) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise AssertionError(f"kernel source no longer matches the patch: {old[:60]!r}")
        text = text.replace(old, new)
    return text


FLASH_LO = ("          mma_bf16(acc[2 * np], al, b[0], b[1]);\n"
            "          if (pair) mma_bf16(acc[2 * np + 1], al, b[2], b[3]);")
FLASH_PV = ("      for (int np = 0; np < KD; ++np) {\n        if (2 * np < nd) {",
            "      for (int np = 0; np < 0; ++np) {\n        if (2 * np < nd) {")
FLASH_QK = ("      if (kk < kd) {\n#pragma unroll\n        for (int np = 0; np < 4; ++np) {",
            "      if (kk < 0) {\n#pragma unroll\n        for (int np = 0; np < 4; ++np) {")
FLASH_LOAD = ("    if (kt < kt_hi) {  // the next tile into the other stage",
              "    if (kt < 0) {  // the next tile into the other stage")


def flash_variants(src: str) -> dict[str, str]:
    return {
        "as_is": src,
        "no_lo_term": patched(src, (FLASH_LO, "")),
        "no_pv": patched(src, FLASH_PV),
        "no_qk": patched(src, FLASH_QK),
        "no_next_tile_load": patched(src, FLASH_LOAD),
        "no_products": patched(src, FLASH_PV, FLASH_QK),
    }


INV_PHASES = ("setup", "take_r", "strip_load", "strip_steps", "strip_out", "update",
              "cluster_sync", "final")


def inv_instrumented(src: str) -> str:
    """The cluster inverse with clock64 marks after each phase, summed
    into P[i] by every thread; thread 0 of block 0 writes them out."""
    return patched(
        src,
        ("template <int NC>\n__global__ void __launch_bounds__(kClusterThreads)\n"
         "    inv_cluster_kernel(",
         "__device__ long long g_phase[8];\ntemplate <int NC>\n"
         "__global__ void __launch_bounds__(kClusterThreads)\n    inv_cluster_kernel("),
        ("  float mx = 0.f;\n  const float* mine",
         "  long long P[8] = {}, T = clock64(), U;\n"
         "#define MARK(i) U = clock64(); P[i] += U - T; T = U;\n"
         "  float mx = 0.f;\n  const float* mine"),
        ("  const float thr = boost_eps * fmaxf(scale, 1e-30f);\n",
         "  const float thr = boost_eps * fmaxf(scale, 1e-30f);\n  MARK(0)\n"),
        ("    take_r(prev, prev_b);  // (iv) of the previous panel\n",
         "    take_r(prev, prev_b);  // (iv) of the previous panel\n    MARK(1)\n"),
        ("    // (ii) the b steps on the strip\n", "    MARK(2)\n    // (ii) the b steps on the strip\n"),
        ("    // R and this CTA's rows' panel columns to shared memory\n",
         "    MARK(3)\n    // R and this CTA's rows' panel columns to shared memory\n"),
        ("    // (iii) tiles of 4 rows x 4 columns; panel rows are computed, not stored\n",
         "    MARK(4)\n    // (iii) tiles of 4 rows x 4 columns; panel rows are computed, not stored\n"),
        ("    cluster.sync();  // (iv)\n", "    MARK(5)\n    cluster.sync();  // (iv)\n    MARK(6)\n"),
        ("    out[(long)(row0 + r) * k + c] = slab[r * ld + c];\n  }\n}",
         "    out[(long)(row0 + r) * k + c] = slab[r * ld + c];\n  }\n  MARK(7)\n"
         "  if (blockIdx.x == 0 && tid == 0)\n    for (int i = 0; i < 8; ++i) g_phase[i] = P[i];\n}\n"
         "extern \"C\" int read_phases(long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * 8);\n}"),
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "common.cuh", OUT / "common.cuh")
    sources = {f"flash_{nm}": text
               for nm, text in flash_variants((CSRC / "flash_attn.cu").read_text()).items()}
    sources["inv_phases"] = inv_instrumented((CSRC / "bcr.cu").read_text())
    procs = {}
    for nm, text in sources.items():
        (OUT / f"{nm}.cu").write_text(text)
        procs[nm] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{nm}.so"), str(OUT / f"{nm}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for nm, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {nm}:\n{log}")
        libs[nm] = ctypes.CDLL(str(OUT / f"{nm}.so"))
        for fn, (restype, argtypes) in build.SIGNATURES[
                "flash_attn" if nm.startswith("flash") else "bcr"].items():
            getattr(libs[nm], fn).restype, getattr(libs[nm], fn).argtypes = restype, argtypes

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    b, hq, hk, t, d = 1, 32, 8, 4096, 128
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, hq, t, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(b, hk, t, d, generator=g, device=dev).bfloat16() for _ in range(2))
    o = torch.empty_like(q)
    flash = {}
    for nm, lib in libs.items():
        if nm.startswith("flash"):
            def run(lib=lib):
                code = lib.flash_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        b, hq, hk, t, t, d, 1, 0, 1, stream)
                if code:
                    raise RuntimeError(f"flash launch failed: {code}")
            flash[nm[6:]] = cuda_ms(run, 20)
    print(json.dumps({"flash": flash, "shape": [b, hq, hk, t, t, d, True, None]}), flush=True)

    lib = libs["inv_phases"]
    for kb, cs in ((400, 4), (400, 8), (190, 1)):
        blocks = kb**-0.5 * torch.randn(2, kb, kb, generator=g, device=dev) + 4 * torch.eye(
            kb, device=dev)
        out = torch.empty(1, kb, kb, device=dev)
        for _ in range(3):
            code = lib.bcr_inv_launch(blocks.data_ptr(), out.data_ptr(), 1, 1, kb, 1e-10, cs, stream)
            if code:
                raise RuntimeError(f"inverse launch failed: {code}")
        torch.cuda.synchronize()
        cycles = (ctypes.c_longlong * 8)()
        if lib.read_phases(cycles):
            raise RuntimeError("reading the phase counters failed")
        print(json.dumps({"inv_phases": {"k": kb, "cluster": cs, "cycles": sum(cycles),
                                         **dict(zip(INV_PHASES, cycles))}}), flush=True)
    lib = build.load("bcr")
    blocks = 190**-0.5 * torch.randn(64, 190, 190, generator=g, device=dev) + 4 * torch.eye(
        190, device=dev)
    out = torch.empty(32, 190, 190, device=dev)
    routes = {}
    for cs in (lib.bcr_inv_cluster_size(190), 0):
        def run(cs=cs):
            code = lib.bcr_inv_launch(blocks.data_ptr(), out.data_ptr(), 32, 1, 190, 1e-10, cs,
                                      stream)
            if code:
                raise RuntimeError(f"inverse launch failed: {code}")
        routes[f"cluster{cs}" if cs else "block"] = cuda_ms(run, 5)
    print(json.dumps({"inv_routes": {"k": 190, "blocks": 32, "ms": routes}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
