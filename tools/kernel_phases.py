#!/usr/bin/env python3
"""Where the time of the redesigned kernels goes, on one NVIDIA card.

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
- ``inv_phases``: the panel inverse on a cluster (``gj_cluster.cuh:
  gj_cluster_inverse``, which ``inv_cluster_kernel``, btf and the fused
  pass call) with ``clock64`` marks around its phases, read by thread 0 of
  the first CTA and summed over the panels, in ``inv_cluster_kernel`` at
  2K = 400 on clusters of 4 and 8 and at 2K = 190 on one CTA; a phase's
  cycles include thread 0's waits at the barriers that end it;
- ``btf_phases``, ``fused_phases``: the two kernels with marks after each
  step of a block row (the products, the scale's cluster barrier, the
  inverse, the store), summed over the rows, beside the inverse's phases
  summed over its calls; and each kernel's time by CUDA events as built
  (the previous inverse read back from device memory) against a copy that
  reads it from the peers' slabs over DSMEM, in turns (``as_is``,
  ``inv_from_peers``, ``as_is_again``): btf at the main shape (P=64,
  M=16, K=200) and on a 63-block chain of 2K = 400, the fused pass at the
  main shape and at SaP-E's P=8 (M=125);
- ``inv_routes``: the built library's two routes for 32 blocks of
  2K = 190, which fit one CTA's shared memory: the cluster kernel on one
  CTA (the route ``bcr_inv_cluster_size`` gives) against the one-block
  kernel, by CUDA events;
- ``bts_phases``: the cluster sweep with marks around each step's phases
  -- its start (the base's load begun), waiting for the running vector
  (the exchange), waiting for the ring's chunk, the product with its
  pushes, the barrier and refill after a chunk -- read by
  thread 0 of the first CTA and given per product, at the main shape
  (P=64, M=16, K=200, R=1), at SaP-E's P=8 split (M=125) and on a 63-block
  chain of 2K = 400, with each launch's time by CUDA events;
- ``reduce_phases``: the reduce products with marks around each slice --
  waiting for the staged slice (``cp.async`` wait and barrier), staging
  the next slice, the FMAs -- summed over every row's first lo tile and
  first D' tile (thread 0), at the first level (m/2 = 32) and the
  last (m/2 = 1) of a 2K = 400 chain, with each level's tile size and
  time.

Then the card's ``nvidia-smi`` name and power limit.  Needs a CUDA card
and nvcc; the patches are exact string replacements and fail loudly when
a kernel source no longer matches them.

    python3 tools/kernel_phases.py --scan-parent DIR

instead times the two SaP-scan wrappers (``wkv6``, ``ssd``) of another
checkout of the repository at DIR (e.g. the parent commit, unpacked by
``git archive``) against this one's, in turns (parent, change, change,
parent), each in a process of its own that imports that tree's package
and builds its kernels: one ``scan_times`` line each, with the device ms
per call (profiler kernel time), the wall ms per call and each call's
route, at RWKV6-1.6B's and Zamba2-2.7B's decode (8 slots, T=1) and
prefill (B=4, T=512, chunk 64) shapes, the inputs rotated through more
than the L2 cache as in chip_smoke.py.

    python3 tools/kernel_phases.py --bcr-parent DIR

does the same for the two BCR solve wrappers (``rhs_reduce``,
``backsub``): one ``bcr_times`` line per turn, with the device ms of
every level of one R=1 solve of the P=64 and the P=500 interface chains
(the d=0.5 band of chip_smoke.py, 63 and 499 blocks of 2K=400) by the
profiler and by chip_smoke.py's ``queued_ms``, each level's inputs
rotated through more than the L2, the grids each call launched (the
profiler's count) and each level's byte bound.  The default run also
stamps the two solve kernels' phases (``solve_phases``: globaltimer and
clock64 by thread 0 of each CTA at the boundaries ``RHS_MARKS`` /
``BACKSUB_MARKS``) at the first and last levels of the P=64 chain.
"""

from __future__ import annotations

import ctypes
import json
import os
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


GJ_PHASES = ("take_r", "strip_load", "strip_steps", "strip_out", "update", "cluster_sync",
             "final")


def gj_instrumented(hdr: str) -> str:
    """gj_cluster.cuh with clock64 marks after each phase of the panel
    inverse, summed into P[i] by every thread; thread 0 of the first CTA
    adds them to g_gj, and the kernels' own marks (kernel_instrumented) go
    to g_kern."""
    return patched(
        hdr,
        ("namespace sap {\n",
         "namespace sap {\n__device__ long long g_gj[8], g_kern[8];\n"
         "#define KMARK(i) U0 = clock64(); Q[i] += U0 - T0; T0 = U0;\n"
         "#define KDONE(n) if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
         "for (int i = 0; i < n; ++i) g_kern[i] += Q[i];\n"),
        ("  C* colbuf = s.colbuf;\n\n",
         "  C* colbuf = s.colbuf;\n  long long P[8] = {}, T = clock64(), U;\n"
         "#define MARK(i) U = clock64(); P[i] += U - T; T = U;\n"),
        ("    take_r(prev, prev_b);  // (iv) of the previous panel\n",
         "    take_r(prev, prev_b);  // (iv) of the previous panel\n    MARK(0)\n"),
        ("    C sv[NC][kPanel];", "    MARK(1)\n    C sv[NC][kPanel];"),
        ("    // R and this CTA's rows' panel columns to shared memory\n",
         "    MARK(2)\n    // R and this CTA's rows' panel columns to shared memory\n"),
        ("    // (iii) tiles of 4 rows x 4 columns; panel rows are computed, not stored\n",
         "    MARK(3)\n    // (iii) tiles of 4 rows x 4 columns; panel rows are computed, not stored\n"),
        ("    cluster.sync();  // (iv)\n", "    MARK(4)\n    cluster.sync();  // (iv)\n    MARK(5)\n"),
        ("  take_r(prev, prev_b);  // the last panel's rows\n  __syncthreads();\n}",
         "  take_r(prev, prev_b);  // the last panel's rows\n  __syncthreads();\n  MARK(6)\n"
         "  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)\n"
         "    for (int i = 0; i < 8; ++i) g_gj[i] += P[i];\n}\n"
         "extern \"C\" int read_phases(long long* gj, long long* kern) {\n"
         "  cudaError_t err = cudaMemcpyFromSymbol(gj, g_gj, sizeof(long long) * 8);\n"
         "  return (int)(err ? err : cudaMemcpyFromSymbol(kern, g_kern, sizeof(long long) * 8));\n}\n"
         "extern \"C\" int reset_phases() {\n  const long long z[8] = {};\n"
         "  cudaError_t err = cudaMemcpyToSymbol(g_gj, z, sizeof(z));\n"
         "  return (int)(err ? err : cudaMemcpyToSymbol(g_kern, z, sizeof(z)));\n}"),
    )


BTF_PHASES = ("row0", "l_product", "s_product", "scale", "inverse", "store")
FUSED_PHASES = ("row0", "l_product", "s_product", "carry_product", "scale", "inverse", "store",
                "corners")
# The DSMEM variant of btf and the fused pass: L_j's right operand, the
# previous inverse, read from the peers' slabs (B.p == nullptr) in place of
# the copy in device memory; a cluster barrier after the product, since the
# next one overwrites the slabs.
DSMEM_STAGE = (
    "  if (b_vec) {\n",
    "  if (B.p == nullptr) {  // the block in the peers' slabs, 16 bytes at a time\n"
    "    cg::cluster_group cluster = cg::this_cluster();\n"
    "    for (int e = tid; e < kStage * n4; e += kClusterThreads) {\n"
    "      const int kk = e / n4, c4 = e - kk * n4, row = k0 + kk;\n"
    "      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);\n"
    "      if (row < q) {\n"
    "        const int owner = row / s.rows;\n"
    "        v = reinterpret_cast<const float4*>(cluster.map_shared_rank(s.w, owner) +\n"
    "                                            (row - owner * s.rows) * ld)[c4];\n"
    "      }\n"
    "      reinterpret_cast<float4*>(bs + kk * ld)[c4] = v;\n"
    "    }\n"
    "  } else if (b_vec) {\n")
DSMEM_BTF = ("rowmajor(inv_prev, k),\n                 none<C>(), C(1), n, k, k);\n"
             "    __syncthreads();", "none<C>(),\n                 none<C>(), C(1), n, k, k);\n"
             "    cluster.sync();")
DSMEM_FUSED = ("rowmajor(inv_prev, k), none<C>(), C(1), n, k, k);\n    __syncthreads();",
               "none<C>(), none<C>(), C(1), n, k, k);\n    cluster.sync();")


def btf_instrumented(src: str) -> str:
    """btf.cu with clock64 marks after each step of a block row, summed
    over the rows into g_kern by thread 0 of the first CTA."""
    return patched(
        src,
        ("  const int n = s.nrows;\n  const long kk",
         "  long long Q[8] = {}, T0 = clock64(), U0;\n  const int n = s.nrows;\n  const long kk"),
        ("  if (!same) slab_store(s, rowmajor(inv_c + mine, k), n);\n\n",
         "  if (!same) slab_store(s, rowmajor(inv_c + mine, k), n);\n  KMARK(0)\n\n"),
        ("    __syncthreads();  // l_j's rows are written\n",
         "    __syncthreads();  // l_j's rows are written\n    KMARK(1)\n"),
        ("    // 3. inv(S_j)\n", "    KMARK(2)\n"),
        ("    scale = cluster_max(cluster, mx, s.red);\n",
         "    scale = cluster_max(cluster, mx, s.red);\n    KMARK(3)\n"),
        ("    if (!same) slab_store(s, rowmajor(inv_c + mine, k), n);\n  }\n}",
         "    if (!same) slab_store(s, rowmajor(inv_c + mine, k), n);\n    KMARK(5)\n  }\n"
         "  KDONE(6)\n}"),
        ("    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));\n"
         "    slab_store",
         "    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));\n"
         "    KMARK(4)\n    slab_store"),
    )


def fused_instrumented(src: str) -> str:
    """fused_spike.cu with the same marks (and the spike carry's product and
    the corners apart)."""
    return patched(
        src,
        ("  const int n = s.nrows, row0 = s.row0;\n",
         "  long long Q[8] = {}, T0 = clock64(), U0;\n  const int n = s.nrows, row0 = s.row0;\n"),
        ("  if (!lu_out) slab_store(s, rowmajor(inv_c + mine, k), n);\n\n",
         "  if (!lu_out) slab_store(s, rowmajor(inv_c + mine, k), n);\n  KMARK(0)\n\n"),
        ("    __syncthreads();  // the multiplier's rows are written\n",
         "    __syncthreads();  // the multiplier's rows are written\n    KMARK(1)\n"),
        ("    // the spike carry: c <- -(mult c), all of the previous carry read\n",
         "    KMARK(2)\n"),
        ("    scale = cluster_max(cluster, mx, s.red);",
         "    KMARK(3)\n    scale = cluster_max(cluster, mx, s.red);"),
        ("    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));\n"
         "    if (side == 0) slab_store",
         "    KMARK(4)\n    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));\n"
         "    KMARK(5)\n    if (side == 0) slab_store"),
        ("    if (!lu_out) slab_store(s, rowmajor(inv_c + mine, k), n);\n  }\n",
         "    if (!lu_out) slab_store(s, rowmajor(inv_c + mine, k), n);\n    KMARK(6)\n  }\n"),
        ("none<C>(), C(1), n, k, k);\n  }\n}",
         "none<C>(), C(1), n, k, k);\n  }\n  KMARK(7)\n  KDONE(8)\n}"),
    )


BTS_PHASES = ("step_start", "exchange_wait", "ring_wait", "product", "sync_refill")


def bts_instrumented(src: str) -> str:
    """bts.cu with clock64 marks around the phases of a product (and of
    each chunk), summed over the sweep into g_kern by thread 0 of the
    first CTA."""
    return patched(
        src,
        ("  int q = 0;  // chunks consumed",
         "  long long Q[8] = {}, T0 = clock64(), U0;\n  int q = 0;  // chunks consumed"),
        ("    if (t > 0) mbar_wait(&vbar[t & 1], ((t - 1) >> 1) & 1);  // exchange: v_t has arrived\n",
         "    KMARK(0)\n    if (t > 0) mbar_wait(&vbar[t & 1], ((t - 1) >> 1) & 1);\n    KMARK(1)\n"),
        ("      mbar_wait(&full[st], (q / stages) & 1);  // ring: chunk q has landed\n",
         "      mbar_wait(&full[st], (q / stages) & 1);\n      KMARK(2)\n"),
        ("      __syncthreads();  // the stage is free (and, after the last chunk, slot t % 2)\n",
         "      KMARK(3)\n      __syncthreads();\n"),
        ("      if (q + stages < total) fetch(q + stages);\n    }\n",
         "      if (q + stages < total) fetch(q + stages);\n      KMARK(4)\n    }\n"),
        ("  cluster.sync();  // no CTA leaves while a peer's pushes may be in flight\n",
         "  KDONE(5)\n  cluster.sync();\n"),
    )


REDUCE_PHASES = ("staging_wait", "stage_next", "fma")


def reduce_instrumented(src: str) -> str:
    """bcr.cu with clock64 marks around each slice of the reduce products,
    summed into g_kern by thread 0 of the first tile of every row."""
    return patched(
        src,
        ("  const int ns = (k + kDepth - 1) / kDepth, total = A2 ? 2 * ns : ns;\n",
         "  const int ns = (k + kDepth - 1) / kDepth, total = A2 ? 2 * ns : ns;\n"
         "  long long Q[8] = {}, T0 = clock64(), U0;\n"),
        ("    cp_async_wait<1>();  // staging: slice s has landed\n",
         "    T0 = clock64();\n    cp_async_wait<1>();\n"),
        ("    __syncthreads();     // ... for every thread; slice s-1's buffer is free\n",
         "    __syncthreads();\n    KMARK(0)\n"),
        ("    cp_async_commit();\n    const C* as = smem",
         "    cp_async_commit();\n    KMARK(1)\n    const C* as = smem"),
        ("acc[i][j] = fma(av, bv[j], acc[i][j]);\n        }\n      }\n    }\n  }\n",
         "acc[i][j] = fma(av, bv[j], acc[i][j]);\n        }\n      }\n    }\n    KMARK(2)\n  }\n"
         "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)\n"
         "    for (int i = 0; i < 3; ++i) atomicAdd(reinterpret_cast<unsigned long long*>(&g_kern[i]),\n"
         "                                          (unsigned long long)Q[i]);\n"),
    )


SOLVE_STAMPS = (
    "using namespace sap;\n",
    "using namespace sap;\n"
    "__device__ unsigned long long g_stamp[256 * 8], g_clock[256 * 8];\n"
    "__device__ inline unsigned long long gtimer() {\n"
    "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n"
    "#define SMARK(i) if (threadIdx.x == 0 && blockIdx.x < 256) { "
    "g_stamp[blockIdx.x * 8 + (i)] = gtimer(); g_clock[blockIdx.x * 8 + (i)] = clock64(); }\n"
    "extern \"C\" int read_stamps(unsigned long long* t, unsigned long long* c) {\n"
    "  cudaError_t err = cudaMemcpyFromSymbol(t, g_stamp, sizeof(g_stamp));\n"
    "  return (int)(err ? err : cudaMemcpyFromSymbol(c, g_clock, sizeof(g_clock)));\n}\n"
    "extern \"C\" int reset_stamps() {\n  static unsigned long long z[256 * 8];\n"
    "  cudaError_t err = cudaMemcpyToSymbol(g_stamp, z, sizeof(z));\n"
    "  return (int)(err ? err : cudaMemcpyToSymbol(g_clock, z, sizeof(z)));\n}\n")
RHS_MARKS = ("entry", "staged", "end")
BACKSUB_MARKS = ("entry", "staged", "peers_running", "t_stored", "cluster_synced", "end")


def solve_instrumented(src: str) -> str:
    """bcr.cu with globaltimer and clock64 stamps by thread 0 of every CTA
    (the first 256) at the phase boundaries of the two solve kernels:
    rhs_reduce RHS_MARKS, backsub BACKSUB_MARKS."""
    return patched(
        src, SOLVE_STAMPS,
        ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
         "  const int ld = solve_ld(k), ldr = ring_ld<T>(k), lane = threadIdx.x & 31,\n"
         "            warp = threadIdx.x >> 5;\n"
         "  const int nw = blockDim.x >> 5, i = blockIdx.x / split, n = solve_rows(k, split);\n",
         "  SMARK(0)\n  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
         "  const int ld = solve_ld(k), ldr = ring_ld<T>(k), lane = threadIdx.x & 31,\n"
         "            warp = threadIdx.x >> 5;\n"
         "  const int nw = blockDim.x >> 5, i = blockIdx.x / split, n = solve_rows(k, split);\n"),
        ("  stage_vector(vn, b + (2L * i + 1) * kr, k, r, ld);\n  __syncthreads();\n",
         "  stage_vector(vn, b + (2L * i + 1) * kr, k, r, ld);\n  __syncthreads();\n  SMARK(1)\n"),
        ("    ring.fetch(st, blocks, j + kSolveStages * nw, row1, k, lane);\n  }\n}\n",
         "    ring.fetch(st, blocks, j + kSolveStages * nw, row1, k, lane);\n  }\n  SMARK(2)\n}\n"),
        ("  cluster_arrive_relaxed();  // waited on before the first store into a peer\n",
         "  SMARK(0)\n  cluster_arrive_relaxed();\n"),
        ("  __syncthreads();\n  cluster_wait();  // every peer is running: its t may be written\n",
         "  __syncthreads();\n  SMARK(1)\n  cluster_wait();\n  SMARK(2)\n"),
        ("  cluster.sync();  // every row of t is in every CTA's copy\n",
         "  SMARK(3)\n  cluster.sync();\n  SMARK(4)\n"),
        ("    a_ring.fetch(st, a_i, j + kSolveStages * nw, row1, k, lane);\n  }\n}\n",
         "    a_ring.fetch(st, a_i, j + kSolveStages * nw, row1, k, lane);\n  }\n  SMARK(5)\n}\n"),
    )


def scan_times() -> dict:
    """Device and wall ms per call of the ``wkv6`` and ``ssd`` wrappers on
    the import path, at the LM path's decode and prefill shapes (the
    inputs, shapes and timing of chip_smoke.py)."""
    import torch

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv import wkv6

    dev = torch.device("cuda")
    rw_h, d, zb_h, n = 32, 64, 80, 64  # RWKV6-1.6B's heads of D; Zamba2-2.7B's of N = P
    out = {}
    for tag, (b, t, c) in {"decode": (cs.LM_SLOTS, 1, 1),
                           "prefill": (cs.PREFILL_B, cs.PREFILL_T, 64)}.items():
        wnext = cs.rotating(lambda seed: cs.wkv_inputs(dev, b * rw_h, t, d, seed),
                            cs.wkv_work(b * rw_h, t, d)[1])
        snext = cs.rotating(lambda seed: cs.ssd_inputs(dev, b * zb_h, t, n, n, zb_h, seed),
                            cs.ssd_work(b * zb_h, t, n, n, zb_h)[1])
        for name, fn in (("wkv", lambda: wkv6(*wnext(), c)),
                         ("ssd", lambda: ssd(*snext(), c, zb_h))):
            reps = 200 if tag == "decode" else 20
            ms, by_kernel = cs.device_ms(fn, reps)
            out[f"{name}_{tag}"] = {"ms": ms, "host_ms": cs.host_ms(fn, reps),
                                    "device_ms_by_kernel": by_kernel}
    out["by_route"] = {nm: dict(getattr(w, "by_route", {})) for nm, w in
                       (("wkv", wkv6), ("ssd", ssd))}
    return out


def parent_compare(parent: Path, what: str) -> None:
    """``{what}_times`` (scan_times or bcr_times) of the checkout at
    ``parent`` and of this one, in turns, each in a process of its own."""
    for who in ("parent", "change", "change", "parent"):
        src = (parent if who == "parent" else ROOT) / "src"
        run = subprocess.run([sys.executable, __file__, f"--{what}-times"], capture_output=True,
                             text=True, env={**os.environ, "PYTHONPATH": str(src)})
        if run.returncode:
            raise RuntimeError(f"{what}_times of {src} failed:\n{run.stdout}{run.stderr}")
        print(json.dumps({f"{what}_times": who, "src": str(src),
                          **json.loads(run.stdout.strip().splitlines()[-1])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


def bcr_times() -> dict:
    """Device ms per call of the ``rhs_reduce`` and ``backsub`` wrappers on
    the import path at every level of one R=1 solve of the P=64 and the
    P=500 interface chains of chip_smoke.py's d=0.5 band (63 and 499 blocks
    of 2K=400), each level's inputs rotated through more than the L2 as in
    chip_smoke.py, with the kernels' grids per call."""
    import numpy as np
    import torch

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import band_to_block_tridiag, random_banded
    from repro_torch.core import cyclic_reduction as cr
    from repro_torch.core.spike import _reduced_interface_system
    from repro_torch.kernels import bcr, ops
    from repro_torch.launch.roofline import H100_DATASHEET

    dev = torch.device("cuda")
    band = torch.tensor(random_banded(cs.N, cs.K, 0.5, seed=cs.SEED).astype(np.float32),
                        device=dev)
    out = {}
    for p in (64, 500):
        bt = band_to_block_tridiag(band, cs.K, p)
        fs = ops.fused_factor_spike(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
        chain = _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
        del bt, fs
        fac = cr.bcr_factor(*chain)
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        b = cr.pad_rhs(torch.randn(chain[0].shape[0], chain[0].shape[1], 1, generator=g,
                                   device=dev), fac.n_levels)
        downs, rhs = [], []
        for lv in fac.levels:
            downs.append((lv.lo, lv.hi, b))
            rhs.append(b)
            b = cr.bcr_rhs_reduce_ref(lv.lo, lv.hi, b)
        x = (fac.root_inv @ b[0])[None]
        ups = []
        for lv, bl_ in zip(reversed(fac.levels), reversed(rhs)):
            ups.append((lv.a_odd, lv.e_odd.contiguous(), lv.f_odd.contiguous(), bl_, x))
            x = cr.bcr_backsub_ref(lv.a_odd, lv.e_odd, lv.f_odd, bl_, x)
        for name, kern, levels in (("rhs_reduce", bcr.rhs_reduce, downs),
                                   ("backsub", bcr.backsub, ups)):
            rows = []
            for args in levels:
                m2, k = args[0].shape[:2]
                nbytes = ops.solve_level_work(m2, k, 1)[name][1]
                nxt = cs.rotating(lambda seed, args=args: tuple(t.clone() for t in args), nbytes)
                reps = 20 if nbytes > cs.L2_BYTES else 100
                ms, by_kernel = cs.device_ms(lambda: kern(*nxt()), reps)
                rows.append({"m2": m2, "ms": ms, "queued_ms": cs.queued_ms(lambda: kern(*nxt()), reps),
                             "grids_per_call": sum(n for _, n, _ in by_kernel.values()),
                             "bound_ms": nbytes / H100_DATASHEET.hbm_bw * 1e3})
                del nxt
            out[f"{name}_p{p}"] = {"levels_ms": sum(r["ms"] for r in rows),
                                   "levels_queued_ms": sum(r["queued_ms"] for r in rows),
                                   "by_level": rows}
        del chain, fac, downs, ups, rhs
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    for what, times in (("scan", scan_times), ("bcr", bcr_times)):
        if f"--{what}-times" in sys.argv:
            print(json.dumps(times()), flush=True)
            return 0
        if f"--{what}-parent" in sys.argv:
            parent = sys.argv[sys.argv.index(f"--{what}-parent") + 1]
            parent_compare(Path(parent).resolve(), what)
            return 0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # OUT: the flash variants and the instrumented solver kernels; OUT/peers:
    # btf and the fused pass reading the previous inverse from the peers' slabs
    peers = OUT / "peers"
    peers.mkdir(parents=True, exist_ok=True)
    for hdr in CSRC.glob("*.cuh"):
        shutil.copy(hdr, OUT / hdr.name)
        shutil.copy(hdr, peers / hdr.name)
    hdr = (CSRC / "gj_cluster.cuh").read_text()
    (OUT / "gj_cluster.cuh").write_text(gj_instrumented(hdr))
    (peers / "gj_cluster.cuh").write_text(patched(hdr, DSMEM_STAGE))
    sources = {f"flash_{nm}": (OUT, text)
               for nm, text in flash_variants((CSRC / "flash_attn.cu").read_text()).items()}
    sources["inv_phases"] = (OUT, reduce_instrumented((CSRC / "bcr.cu").read_text()))
    sources["solve_phases"] = (OUT, solve_instrumented((CSRC / "bcr.cu").read_text()))
    sources["bts_phases"] = (OUT, bts_instrumented((CSRC / "bts.cu").read_text()))
    sources["btf_phases"] = (OUT, btf_instrumented((CSRC / "btf.cu").read_text()))
    sources["fused_phases"] = (OUT, fused_instrumented((CSRC / "fused_spike.cu").read_text()))
    sources["btf_peers"] = (peers, patched((CSRC / "btf.cu").read_text(), DSMEM_BTF))
    sources["fused_peers"] = (peers, patched((CSRC / "fused_spike.cu").read_text(), DSMEM_FUSED))
    procs = {}
    for nm, (where, text) in sources.items():
        (where / f"{nm}.cu").write_text(text)
        procs[nm] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(where / f"{nm}.so"),
             str(where / f"{nm}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kinds = {"flash": "flash_attn", "inv": "bcr", "btf": "btf", "fused": "fused_spike", "bts": "bts",
             "solve": "bcr"}
    libs = {}
    for nm, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {nm}:\n{log}")
        libs[nm] = ctypes.CDLL(str(sources[nm][0] / f"{nm}.so"))
        for fn, (restype, argtypes) in build.SIGNATURES[kinds[nm.split("_")[0]]].items():
            getattr(libs[nm], fn).restype, getattr(libs[nm], fn).argtypes = restype, argtypes
        if nm.endswith("_phases"):
            libs[nm].read_phases.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        if nm == "solve_phases":
            libs[nm].read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    import numpy as np

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

    def phases(lib, launch):
        """(the panel inverse's cycles by phase, the kernel's by phase) of
        one launch, read from thread 0 of the first CTA."""
        launch()  # warm
        torch.cuda.synchronize()
        if lib.reset_phases():
            raise RuntimeError("resetting the phase counters failed")
        launch()
        torch.cuda.synchronize()
        gj, kern = (ctypes.c_longlong * 8)(), (ctypes.c_longlong * 8)()
        if lib.read_phases(gj, kern):
            raise RuntimeError("reading the phase counters failed")
        return list(gj), list(kern)

    def checked(code, what):
        if code:
            raise RuntimeError(f"{what} launch failed: {code}")

    lib = libs["inv_phases"]
    for kb, cs in ((400, 4), (400, 8), (190, 1)):
        blocks = kb**-0.5 * torch.randn(2, kb, kb, generator=g, device=dev) + 4 * torch.eye(
            kb, device=dev)
        out = torch.empty(1, kb, kb, device=dev)
        gj, _ = phases(lib, lambda: checked(lib.bcr_inv_launch(
            blocks.data_ptr(), out.data_ptr(), None, 1, 1, kb, 1e-10, cs, stream), "inverse"))
        print(json.dumps({"inv_phases": {"k": kb, "cluster": cs, "cycles": sum(gj),
                                         **dict(zip(GJ_PHASES, gj))}}), flush=True)

    # btf and the fused pass: the main shape (P=64, M=16, K=200), the fused
    # pass at SaP-E's P=8 (M=125) and btf on a 63-block chain of 2K=400
    from repro_torch.core import band_to_block_tridiag, random_banded
    from repro_torch.core.block_lu import pad_couplings

    def split(p):
        band = torch.tensor(random_banded(200_000, 200, 1.0, seed=0).astype(np.float32),
                            device=dev)
        bt = band_to_block_tridiag(band, 200, p)
        return bt.d, bt.e, bt.f, *pad_couplings(bt.b_cpl, bt.c_cpl, p)

    def btf_run(lib, d, e, f):
        p, m, k, _ = d.shape
        cs = lib.btf_cluster_size(p, k)
        sinv, l = torch.empty_like(d), torch.empty_like(d)
        ws = torch.empty(max(1, p * lib.btf_workspace_floats(k, cs)), device=dev)
        return cs, lambda: checked(lib.btf_launch(
            d.data_ptr(), e.data_ptr(), f.data_ptr(), sinv.data_ptr(), l.data_ptr(),
            ws.data_ptr(), p, m, k, 1e-10, cs, stream), "btf")

    def fused_run(lib, d, e, f, bq, cq):
        p, m, k, _ = d.shape
        cs = lib.fused_cluster_size(p, k)
        outs = [torch.empty_like(d), torch.empty_like(d)] + [torch.empty_like(bq) for _ in range(4)]
        ws = torch.empty(max(1, p * lib.fused_workspace_floats(k, cs)), device=dev)
        return cs, lambda: checked(lib.fused_launch(
            d.data_ptr(), e.data_ptr(), f.data_ptr(), bq.data_ptr(), cq.data_ptr(),
            *[o.data_ptr() for o in outs], ws.data_ptr(), p, m, k, 1e-10, cs, stream), "fused")

    main, p8 = split(64), split(8)
    kb = 400
    sc = kb**-0.5
    chain = (sc * torch.randn(1, 63, kb, kb, generator=g, device=dev) + 4 * torch.eye(kb, device=dev),
             0.3 * sc * torch.randn(1, 63, kb, kb, generator=g, device=dev),
             0.3 * sc * torch.randn(1, 63, kb, kb, generator=g, device=dev))
    shipped = {"btf": build.load("btf"), "fused": build.load("fused_spike")}
    cases = (("btf", "main", main[:3]), ("btf", "chain400", chain), ("fused", "main", main),
             ("fused", "p8", p8))
    for kind, tag, args in cases:
        run = btf_run if kind == "btf" else fused_run
        cs, launch = run(libs[f"{kind}_phases"], *args)
        gj, kern = phases(libs[f"{kind}_phases"], launch)
        names = BTF_PHASES if kind == "btf" else FUSED_PHASES
        ms = {}
        for nm, lib in (("as_is", shipped[kind]), ("inv_from_peers", libs[f"{kind}_peers"]),
                        ("as_is_again", shipped[kind])):
            ms[nm] = cuda_ms(run(lib, *args)[1], 3)
        print(json.dumps({f"{kind}_phases": {
            "at": tag, "shape": list(args[0].shape), "cluster": cs, "ms": ms,
            "kernel_cycles": sum(kern), **dict(zip(names, kern)),
            "inverse_by_phase": dict(zip(GJ_PHASES, gj))}}), flush=True)
    lib = build.load("bcr")
    blocks = 190**-0.5 * torch.randn(64, 190, 190, generator=g, device=dev) + 4 * torch.eye(
        190, device=dev)
    out = torch.empty(32, 190, 190, device=dev)
    routes = {}
    for cs in (lib.bcr_inv_cluster_size(190), 0):
        def run(cs=cs):
            code = lib.bcr_inv_launch(blocks.data_ptr(), out.data_ptr(), None, 32, 1, 190,
                                      1e-10, cs, stream)
            if code:
                raise RuntimeError(f"inverse launch failed: {code}")
        routes[f"cluster{cs}" if cs else "block"] = cuda_ms(run, 5)
    print(json.dumps({"inv_routes": {"k": 190, "blocks": 32, "ms": routes}}), flush=True)

    # bts: random factors (the sweep is linear; their values do not change
    # its work), scaled so that the running vector stays bounded
    lib = libs["bts_phases"]
    for tag, (p, m, k) in (("main", (64, 16, 200)), ("p8", (8, 125, 200)),
                           ("chain400", (1, 63, 400))):
        sc = k**-0.5
        sinv = sc * torch.randn(p, m, k, k, generator=g, device=dev)
        l, f = (0.3 * sc * torch.randn(p, m, k, k, generator=g, device=dev) for _ in range(2))
        b = torch.randn(p, m, k, 1, generator=g, device=dev)
        x = torch.empty_like(b)
        cs = lib.bts_cluster_size(p, k, 1)

        def run(lib=lib, cs=cs):
            checked(lib.bts_launch(sinv.data_ptr(), l.data_ptr(), f.data_ptr(), b.data_ptr(),
                                   x.data_ptr(), x.data_ptr(), p, m, k, 1, cs, stream), "bts")
        _, kern = phases(lib, run)
        steps = 3 * m - 2
        print(json.dumps({"bts_phases": {
            "at": tag, "shape": [p, m, k, 1], "cluster": cs,
            "stages": lib.bts_ring_stages(k, cs, 1), "products": steps,
            "ms": cuda_ms(lambda: run(build.load("bts"), cs), 20),
            "cycles_per_product": sum(kern) / steps,
            **{nm: c / steps for nm, c in zip(BTS_PHASES, kern)}}}), flush=True)
        del sinv, l, f

    # reduce at the first and the last level of a 2K = 400 chain
    lib = libs["inv_phases"]
    for m2 in (32, 1):
        kb, sc = 400, 400**-0.5
        d = sc * torch.randn(2 * m2, kb, kb, generator=g, device=dev) + 4 * torch.eye(kb, device=dev)
        e, f = (0.3 * sc * torch.randn(2 * m2, kb, kb, generator=g, device=dev) for _ in range(2))
        a = sc * torch.randn(m2, kb, kb, generator=g, device=dev)
        outs = [torch.empty_like(a) for _ in range(5)]
        tile = lib.bcr_reduce_tile(m2, kb)

        def run(lib=lib):
            checked(lib.bcr_reduce_launch(d.data_ptr(), e.data_ptr(), f.data_ptr(), a.data_ptr(),
                                          *[o.data_ptr() for o in outs], None, m2, kb, 0,
                                          stream),
                    "reduce")
        _, kern = phases(lib, run)
        slices = m2 * 3 * -(-kb // 16)  # each row's first lo tile and first D' tile (2 products)
        print(json.dumps({"reduce_phases": {
            "m2": m2, "k": kb, "tile": tile, "ms": cuda_ms(lambda: run(build.load("bcr")), 10),
            "slices": slices, "cycles": sum(kern[:3]),
            **{nm: c for nm, c in zip(REDUCE_PHASES, kern)},
            "fma_share": kern[2] / max(sum(kern[:3]), 1)}}), flush=True)
        del d, e, f, a, outs
    # the solve kernels at the first and the last levels of the P=64 chain
    # (2K = 400, R = 1), on the sizes their rule gives: each CTA's stamps
    # (thread 0) at the phase boundaries, read back after one launch
    lib = libs["solve_phases"]
    for kind, m2 in (("rhs_reduce", 32), ("rhs_reduce", 1), ("backsub", 32), ("backsub", 8),
                     ("backsub", 1)):
        kb, sc = 400, 400**-0.5
        lo, hi, a, e, f = (sc * torch.randn(m2, kb, kb, generator=g, device=dev) for _ in range(5))
        b = torch.randn(2 * m2, kb, 1, generator=g, device=dev)
        x = torch.randn(m2, kb, 1, generator=g, device=dev)
        out = torch.empty(2 * m2, kb, 1, device=dev)
        if kind == "rhs_reduce":
            size, marks = lib.bcr_rhs_reduce_split(m2, kb, 1), RHS_MARKS

            def run(lib=lib, size=size):
                checked(lib.bcr_rhs_reduce_launch(lo.data_ptr(), hi.data_ptr(), b.data_ptr(),
                                                  out.data_ptr(), m2, kb, 1, size, stream), kind)
        else:
            size, marks = lib.bcr_backsub_cluster(m2, kb, 1), BACKSUB_MARKS

            def run(lib=lib, size=size):
                checked(lib.bcr_backsub_launch(a.data_ptr(), e.data_ptr(), f.data_ptr(),
                                               b.data_ptr(), x.data_ptr(), None, out.data_ptr(),
                                               m2, kb, 1, size, stream), kind)
        run()
        torch.cuda.synchronize()
        if lib.reset_stamps():
            raise RuntimeError("resetting the stamps failed")
        run()
        torch.cuda.synchronize()
        t, c = (ctypes.c_ulonglong * (256 * 8))(), (ctypes.c_ulonglong * (256 * 8))()
        if lib.read_stamps(t, c):
            raise RuntimeError("reading the stamps failed")
        ctas = min(256, m2 * size)
        ts = np.array(t, dtype=np.float64).reshape(256, 8)[:ctas, :len(marks)]
        cyc = np.array(c, dtype=np.float64).reshape(256, 8)[:ctas, :len(marks)]
        step = np.diff(cyc, axis=1)  # each CTA's cycles between consecutive marks
        print(json.dumps({"solve_phases": {
            "kernel": kind, "m2": m2, "k": kb, "size": size, "ctas": ctas,
            "span_us": (ts[:, -1].max() - ts[:, 0].min()) / 1e3,
            "entry_spread_us": (ts[:, 0].max() - ts[:, 0].min()) / 1e3,
            "cta_us_mean": float((ts[:, -1] - ts[:, 0]).mean()) / 1e3,
            "cycles_mean": dict(zip([f"{a}->{b}" for a, b in zip(marks, marks[1:])],
                                    step.mean(axis=0).tolist())),
            "cycles_max": dict(zip([f"{a}->{b}" for a, b in zip(marks, marks[1:])],
                                   step.max(axis=0).tolist())),
            "ms_events": cuda_ms(lambda: run(build.load("bcr")), 50)}}), flush=True)
        del lo, hi, a, e, f, b, x, out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
