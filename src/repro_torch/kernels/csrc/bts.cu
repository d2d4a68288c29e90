// Block-tridiagonal solve of P factored chains for R right-hand sides
// (the SaP preconditioner apply).
//
// Replaces the TPU kernels repro/kernels/bts.py:_fwd_kernel and _bwd_kernel
// (bts_pallas).  Both sweeps run in one launch:
//   forward   y_0 = b_0,            y_j = b_j - L_j y_{j-1}
//   backward  x_{M-1} = Sinv y,     x_j = Sinv_j (y_j - F_j x_{j+1})
// The backward loop walks j from M-1 down, which takes the place of the
// TPU kernel's reversed index map; y lives in the output x.
//
// Bound: bytes.  Each apply reads sinv, l and f once (3 M K^2 floats per
// partition) for ~6 M K^2 R flops, 0.5 flop per byte at R = 1.
//
// Design (bts_cluster_kernel, R <= 8): a thread-block cluster of cs CTAs
// per chain, CTA r owning the rows [r n, r n + n), n = ceil(K / cs), of
// every K x K block -- n K contiguous floats of a row-major block.  The
// sweep is a sequence of 3M - 2 products, one K x K block each:
//   t <  M-1        L_{t+1}:  y_{t+1} = b_{t+1} - L y_t
//   t == M-1        Sinv_{M-1}: x_{M-1} = Sinv y_{M-1}
//   t = M + 2u      F_j (j = M-2-u): T = y_j - F_j x_{j+1}
//   t = M + 2u + 1  Sinv_j:  x_j = Sinv_j T
// None of the blocks depends on the running vector, so each CTA streams
// its rows of them through a ring of shared-memory stages, each a chunk of
// up to 16 rows (one a warp), as far ahead as the ring holds: by TMA bulk
// copies (cp.async.bulk, completion on an mbarrier) when K % 4 == 0 and
// the blocks are 16-byte aligned, else by 4-byte cp.async that arrive on
// the same mbarriers.  A warp forms one output row per chunk, its lanes
// along K against the full K x R vector in shared memory, and pushes the
// row into every CTA's vector slot by st.async (DSMEM stores that
// complete on the receiver's mbarrier; never remote loads) as soon as it
// is formed.  A CTA starts a product once its slot has received all K x R
// values: no cluster barrier in the sweep.  Two slots alternate, which is enough: a peer can
// only write the slot a CTA reads once it has every row of the next
// vector, and a CTA pushes its last row after its last read.  T never
// leaves shared memory; a warp loads its row's base (b_j, or y_j from x)
// before it waits for the vector or the chunk.  The cluster size comes
// from the shape (bts_cluster_size): 1, doubled while the P clusters still
// fit on the card at once.
//
// bts_kernel: one thread block per partition, for R > 8 (whole spikes,
// R = K) and blocks too large for the ring; T goes through a K x R
// workspace per partition.
#include "gj_cluster.cuh"

using namespace sap;

__global__ void __launch_bounds__(kThreads)
    bts_kernel(const float* __restrict__ sinv, const float* __restrict__ l,
               const float* __restrict__ f, const float* __restrict__ b, float* x, float* ws,
               int m, int k, int r) {
  const long kk = (long)k * k, kr = (long)k * r;
  const long bm = (long)blockIdx.x * m * kk, bv = (long)blockIdx.x * m * kr;
  float* T = ws + blockIdx.x * kr;

  block_copy(rowmajor(x + bv, r), rowmajor(b + bv, r), k, r);
  __syncthreads();
  for (int j = 1; j < m; ++j) {
    gemm(rowmajor(x + bv + j * kr, r), rowmajor(l + bm + j * kk, k),
         rowmajor(x + bv + (j - 1) * kr, r), rowmajor(b + bv + j * kr, r), -1.f, k, k, r);
    __syncthreads();
  }
  block_copy(rowmajor(T, r), rowmajor(x + bv + (m - 1) * kr, r), k, r);
  __syncthreads();
  gemm(rowmajor(x + bv + (m - 1) * kr, r), rowmajor(sinv + bm + (m - 1) * kk, k), rowmajor(T, r),
       none(), 1.f, k, k, r);
  __syncthreads();
  for (int j = m - 2; j >= 0; --j) {
    gemm(rowmajor(T, r), rowmajor(f + bm + j * kk, k), rowmajor(x + bv + (j + 1) * kr, r),
         rowmajor(x + bv + j * kr, r), -1.f, k, k, r);
    __syncthreads();
    gemm(rowmajor(x + bv + j * kr, r), rowmajor(sinv + bm + j * kk, k), rowmajor(T, r), none(),
         1.f, k, k, r);
    __syncthreads();
  }
}

namespace {

constexpr int kChunkRows = 16;         // rows of a ring chunk: one a warp
constexpr int kChunkFloatsMax = 8192;  // 32 KB: fewer rows a chunk above K = 512
constexpr int kRingMax = 8;            // stages
constexpr int kBars = kRingMax + 2;
// lane 0 of the last warp starts the ring's TMA copies: at P = 8 that warp
// has no row, so the copies stay off the sweep's critical path
constexpr int kProducer = kClusterThreads - 32;
constexpr int kMaxK = 1024;            // larger blocks take the one-block kernel
// shared bytes a CTA may take so that two fit on an SM (228 KB, 1 KB of it
// reserved per CTA)
constexpr size_t kTwoPerSm = 112 * 1024;

__host__ __device__ inline int rmax_of(int r) { return r == 1 ? 1 : r <= 4 ? 4 : 8; }
__host__ __device__ inline int chunk_rows(int k) {
  return imin(kChunkRows, imax(1, kChunkFloatsMax / k));
}
__host__ __device__ inline int stage_floats(int k) { return (chunk_rows(k) * k + 3) & ~3; }

// Shared bytes besides the ring: the mbarriers and two vector slots (K x RMAX).
inline size_t fixed_bytes(int k, int r) {
  return (size_t)kBars * 8 + sizeof(float) * 2 * (size_t)k * rmax_of(r);
}

// Ring stages for (K, R): as many as fit beside the fixed part within
// kTwoPerSm, at most kRingMax; when fewer than two fit there, as many as the
// opt-in maximum holds.  0 when two stages do not fit at all.
inline int ring_stages(int k, int r) {
  const size_t fixed = fixed_bytes(k, r), stage = sizeof(float) * stage_floats(k);
  const size_t budgets[2] = {kTwoPerSm, (size_t)smem_optin()};
  for (size_t budget : budgets) {
    if (budget <= fixed) continue;
    const int s = (int)imin(kRingMax, (int)((budget - fixed) / stage));
    if (s >= 2) return s;
  }
  return 0;
}

inline size_t cluster_smem(int k, int r) {
  return fixed_bytes(k, r) + sizeof(float) * (size_t)ring_stages(k, r) * stage_floats(k);
}

// ---- PTX helpers: DSMEM pushes (mbarriers and bulk copies: gj_cluster.cuh) ----

// v into the peer CTA's shared memory at the cluster address `dst`,
// completing `bytes` on the peer's mbarrier at cluster address `bar`
__device__ inline void push4(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(dst),
               "f"(v), "r"(bar)
               : "memory");
}
__device__ inline void push16(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::
          "r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
// the cluster address of a local shared address in CTA `rank`
__device__ inline uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

}  // namespace

// One chain per cluster of cs CTAs; grid (P cs), cluster (cs), kClusterThreads
// threads; `stages` ring stages (ring_stages); bulk: TMA copies (K % 4 == 0,
// 16-byte aligned blocks) or 4-byte cp.async.  RMAX: 1, 4 or 8 >= R, the
// vector slots' row stride.
template <int RMAX>
__global__ void __launch_bounds__(kClusterThreads, 2)
    bts_cluster_kernel(const float* __restrict__ sinv, const float* __restrict__ l,
                       const float* __restrict__ f, const float* __restrict__ b, float* x, int m,
                       int k, int r, int stages, int bulk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = slab_rows(k, cs), row0 = rank * n, nrows = max(0, min(n, k - row0));
  const int cr = chunk_rows(k), sfl = stage_floats(k);
  const int nch = (nrows + cr - 1) / cr;  // chunks of a block (0 for a CTA past K)
  const int nmat = 3 * m - 2, total = nmat * nch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [stages]: chunk landed
  uint64_t* vbar = full + kRingMax;                          // [2]: slot received
  float* ring = reinterpret_cast<float*>(smem_raw + kBars * 8);
  float* slot0 = ring + stages * sfl;  // two K x RMAX vector slots
  const long kk = (long)k * k, kr = (long)k * r, chain = (long)(blockIdx.x / cs) * m;
  const float* bc = b + chain * kr;
  float* xc = x + chain * kr;

  // the block of product t
  auto block_of = [&](int t) -> const float* {
    if (t < m - 1) return l + (chain + t + 1) * kk;
    if (t == m - 1) return sinv + (chain + m - 1) * kk;
    const int u = t - m, j = m - 2 - u / 2;
    return ((u & 1) ? sinv : f) + (chain + j) * kk;
  };
  // chunk q of the stream into stage q % stages
  auto fetch = [&](int q) {
    const int t = q / nch, c = q - t * nch, st = q % stages;
    const int rows = min(cr, nrows - c * cr);
    const float* src = block_of(t) + (long)(row0 + c * cr) * k;
    float* dst = ring + st * sfl;
    if (bulk) {
      if (tid == kProducer) {
        mbar_expect_tx(&full[st], (uint32_t)(rows * k * sizeof(float)));
        bulk_copy(dst, src, (uint32_t)(rows * k * sizeof(float)), &full[st]);
      }
    } else {
      for (int e = tid; e < rows * k; e += kClusterThreads) cp_async4(dst + e, src + e);
      cp_async_arrive(&full[st]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], bulk ? 1 : kClusterThreads);
    mbar_init(&vbar[0], 1);
    mbar_init(&vbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // y_0 = b_0: all of it into slot 0, this CTA's rows into x_0; the slots'
  // padding columns zero
  for (int e = tid; e < 2 * k * RMAX; e += kClusterThreads) {
    const int s = e / RMAX, c = e - s * RMAX;
    slot0[e] = s < k && c < r ? bc[s * r + c] : 0.f;
  }
  for (int e = tid; e < nrows * r; e += kClusterThreads) xc[row0 * r + e] = bc[row0 * r + e];
  cluster.sync();  // the peers are running, the mbarriers initialised, x_0 written
  for (int q = 0; q < min(stages, total); ++q) fetch(q);

  int q = 0;  // chunks consumed
  for (int t = 0; t < nmat; ++t) {
    const bool fwd = t < m - 1, has_base = fwd || (t >= m && ((t - m) & 1) == 0);
    const bool last = t == nmat - 1;
    // the output's rows in x (none for T), its base (b_{t+1}, or y_j still
    // in x_j, written by this CTA before an earlier barrier) and its sign
    float* out = fwd ? xc + (t + 1) * kr
                     : t == m - 1 ? xc + (m - 1) * kr
                                  : (((t - m) & 1) ? xc + (long)(m - 2 - (t - m) / 2) * kr : nullptr);
    const float* base = fwd ? bc + (t + 1) * kr : has_base ? xc + (long)(m - 2 - (t - m) / 2) * kr
                                                             : nullptr;
    const float sign = has_base ? -1.f : 1.f;
    const float* vin = slot0 + (t & 1) * k * RMAX;
    float* vout = slot0 + ((t + 1) & 1) * k * RMAX;
    // the warp's base values of its row in chunk c, loaded before the waits
    float bv[RMAX];
    auto load_base = [&](int c) {
      const int i = c * cr + warp;
      if (base != nullptr && c < nch && warp < min(cr, nrows - c * cr))
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc) bv[cc] = cc < r ? base[(long)(row0 + i) * r + cc] : 0.f;
    };
    load_base(0);
    if (t > 0) mbar_wait(&vbar[t & 1], ((t - 1) >> 1) & 1);  // exchange: v_t has arrived
    if (!last && tid == kProducer)
      mbar_expect_tx(&vbar[(t + 1) & 1], (uint32_t)(k * r * sizeof(float)));
    for (int c = 0; c < nch; ++c, ++q) {
      if (c > 0) load_base(c);
      const int st = q % stages;
      mbar_wait(&full[st], (q / stages) & 1);  // ring: chunk q has landed
      const int rows = min(cr, nrows - c * cr);
      if (warp < rows) {
        const int i = c * cr + warp;  // the CTA's row
        const float* a = ring + st * sfl + warp * k;
        float acc[RMAX];
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc) acc[cc] = 0.f;
#pragma unroll 4
        for (int s = lane; s < k; s += 32) {
          const float av = a[s];
          if (RMAX == 1) {
            acc[0] = fmaf(av, vin[s], acc[0]);
          } else {
#pragma unroll
            for (int c4 = 0; c4 < RMAX / 4; ++c4) {
              const float4 v = reinterpret_cast<const float4*>(vin + s * RMAX)[c4];
              acc[4 * c4] = fmaf(av, v.x, acc[4 * c4]);
              acc[4 * c4 + 1] = fmaf(av, v.y, acc[4 * c4 + 1]);
              acc[4 * c4 + 2] = fmaf(av, v.z, acc[4 * c4 + 2]);
              acc[4 * c4 + 3] = fmaf(av, v.w, acc[4 * c4 + 3]);
            }
          }
        }
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[cc] += __shfl_xor_sync(0xffffffffu, acc[cc], o);
        // row i = base - (block row) v, or + for Sinv, at once: lane 0
        // writes it to x and lane p pushes it into CTA p's slot, so the
        // next product waits on no barrier of this one
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc)
          if (cc < r) acc[cc] = (has_base ? bv[cc] : 0.f) + sign * acc[cc];
        if (out != nullptr && lane == 0)
          for (int cc = 0; cc < r; ++cc) out[(long)(row0 + i) * r + cc] = acc[cc];
        if (!last)
          for (int p = lane; p < cs; p += 32) {
            const uint32_t dst = cluster_addr(vout + (row0 + i) * RMAX, p);
            const uint32_t bar = cluster_addr(&vbar[(t + 1) & 1], p);
            if (RMAX > 1 && r == RMAX) {
#pragma unroll
              for (int c4 = 0; c4 < RMAX / 4; ++c4)
                push16(dst + 16 * c4,
                       make_float4(acc[4 * c4], acc[4 * c4 + 1], acc[4 * c4 + 2], acc[4 * c4 + 3]),
                       bar);
            } else {
#pragma unroll
              for (int cc = 0; cc < RMAX; ++cc)
                if (cc < r) push4(dst + 4 * cc, acc[cc], bar);
            }
          }
      }
      __syncthreads();  // the stage is free (and, after the last chunk, slot t % 2)
      if (q + stages < total) fetch(q + stages);
    }
    // threads stay within a product of each other, so no thread polls an
    // mbarrier phase that has already been re-armed
    if (nch == 0) __syncthreads();
  }
  cluster.sync();  // no CTA leaves while a peer's pushes may be in flight
}

namespace {

using BtsClusterKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                                  int, int, int, int, int);

BtsClusterKernel cluster_kernel(int r) {
  return r == 1 ? bts_cluster_kernel<1> : r <= 4 ? bts_cluster_kernel<4> : bts_cluster_kernel<8>;
}

bool cluster_route_fits(int k, int r) {
  return r >= 1 && r <= kNarrow && k >= 1 && k <= kMaxK && ring_stages(k, r) >= 2;
}

// TMA bulk copies need 16-byte aligned sources and sizes: K % 4 == 0 and
// aligned blocks; otherwise the ring fills by 4-byte cp.async.
int bulk_route(const float* sinv, const float* l, const float* f, int k) {
  auto aligned = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  return k % 4 == 0 && aligned(sinv) && aligned(l) && aligned(f);
}

}  // namespace

// The cluster size a bts launch of P chains of K x K blocks with R
// right-hand sides takes: 1..16, or 0 for the one-block kernel (R > 8, or
// blocks whose ring does not fit); a negative cudaError_t code on failure.
extern "C" int bts_cluster_size(int p, int k, int r) {
  if (p <= 0 || k <= 0 || r <= 0) return -(int)cudaErrorInvalidValue;
  if (!cluster_route_fits(k, r)) return 0;
  return grow_cluster(cluster_kernel(r), p, 1, [k, r](int) { return cluster_smem(k, r); });
}

// The ring stages and shared bytes of a cluster launch (for the record).
extern "C" int bts_ring_stages(int k, int cluster, int r) {
  return cluster_route_fits(k, r) && cluster >= 1 ? ring_stages(k, r) : 0;
}

// Floats of device workspace each partition needs on the route of a
// cluster size (0: the one-block kernel, which stages T in K x R floats).
extern "C" long bts_workspace_floats(int k, int r, int cluster) {
  return cluster > 0 ? 0 : (long)k * r;
}

// cluster: the size bts_cluster_size gives, or (tests) any size 1..16;
// 0 launches the one-block kernel.  A route that does not fit the shape,
// or a size the card cannot schedule, is an error, never a fallback.
extern "C" int bts_launch(const float* sinv, const float* l, const float* f, const float* b,
                          float* x, float* ws, int p, int m, int k, int r, int cluster,
                          void* stream) {
  if (p <= 0 || m <= 0 || k <= 0 || r <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    bts_kernel<<<p, kThreads, 0, (cudaStream_t)stream>>>(sinv, l, f, b, x, ws, m, k, r);
    return (int)cudaGetLastError();
  }
  if (!cluster_route_fits(k, r)) return (int)cudaErrorInvalidValue;
  const int stages = ring_stages(k, r);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(k, r);
  const BtsClusterKernel kern = cluster_kernel(r);
  const int active = max_active_clusters(kern, cluster, smem);
  if (active < 0) return -active;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  const int bulk = bulk_route(sinv, l, f, k);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(p * cluster), cluster, smem, (cudaStream_t)stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, sinv, l, f, b, x, m, k, r, stages, bulk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Whether a cluster launch of these operands takes the TMA bulk copies (1)
// or 4-byte cp.async (0).
extern "C" int bts_bulk_route(const float* sinv, const float* l, const float* f, int k) {
  return bulk_route(sinv, l, f, k);
}
