// Block-tridiagonal solve of P factored chains for R right-hand sides
// (the SaP preconditioner apply).
//
// Replaces the TPU kernels repro/kernels/bts.py:_fwd_kernel and _bwd_kernel
// (bts_pallas).  Both sweeps run in one launch:
//   forward   y_0 = b_0,            y_j = b_j - L_j y_{j-1}
//   backward  x_{M-1} = Sinv y,     x_j = Sinv_j (y_j - F_j x_{j+1})
// The backward loop walks j from M-1 down, which takes the place of the
// TPU kernel's reversed index map; y lives in the output x (a compute-type
// workspace for bfloat16).
//
// Bound: bytes.  Each apply reads sinv, l and f once (3 M K^2 elements per
// partition) for ~6 M K^2 R flops, 0.5 flop per byte at R = 1 in float32.
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
// up to 16 rows (one a warp), as far ahead as the ring holds, in the
// storage type: by TMA bulk copies (cp.async.bulk, completion on an
// mbarrier) when a row is a multiple of 16 bytes (K % 4 == 0 for float32,
// K % 8 for bfloat16, K % 2 for float64) and the blocks are 16-byte
// aligned, else by element-wide cp.async (float32, float64) or plain
// copies (bfloat16, whose odd elements are only 2-byte aligned) that
// arrive on the same mbarriers.  A warp forms one output row per chunk, its lanes
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
//
// Storage types (common.cuh): float32, bfloat16 and float64, each with
// its own entry points (bts_launch, bts_launch_bf16, bts_launch_f64);
// bfloat16 computes in float32, float64 in float64.  The blocks stream in
// the storage type (bfloat16 halves the bytes, the bound); the running
// vector, its DSMEM pushes and the sweep's y stay in the compute type --
// for bfloat16 y goes to an M x K x R float32 workspace a chain instead of
// x, and x is stored rounded once.
#include "gj_cluster.cuh"

using namespace sap;

namespace {

// Elements of C of a chain's workspace: the sweep's y (M x K x R) when T
// != C, then on the one-block route T (K x R).
template <typename T>
__host__ __device__ inline long ws_per_chain(int m, int k, int r, int cluster) {
  const long kr = (long)k * r;
  return (std::is_same<T, Compute<T>>::value ? 0 : (long)m * kr) + (cluster > 0 ? 0 : kr);
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bts_kernel(const T* __restrict__ sinv, const T* __restrict__ l, const T* __restrict__ f,
               const T* __restrict__ b, T* x, Compute<T>* ws, int m, int k, int r) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  const long kk = (long)k * k, kr = (long)k * r;
  const long bm = (long)blockIdx.x * m * kk, bv = (long)blockIdx.x * m * kr;
  C* slot = ws + blockIdx.x * ws_per_chain<T>(m, k, r, 0);
  C* xw = same ? reinterpret_cast<C*>(x + bv) : slot;  // the chain's y, then x, in C
  C* Tw = slot + (same ? 0 : m * kr);

  block_copy<C>(rowmajor(xw, r), rowmajor(b + bv, r), k, r);
  __syncthreads();
  for (int j = 1; j < m; ++j) {
    gemm(rowmajor(xw + j * kr, r), rowmajor(l + bm + j * kk, k), rowmajor(xw + (j - 1) * kr, r),
         rowmajor(b + bv + j * kr, r), C(-1), k, k, r);
    __syncthreads();
  }
  block_copy<C>(rowmajor(Tw, r), rowmajor(xw + (m - 1) * kr, r), k, r);
  __syncthreads();
  gemm(rowmajor(xw + (m - 1) * kr, r), rowmajor(sinv + bm + (m - 1) * kk, k), rowmajor(Tw, r),
       none<C>(), C(1), k, k, r);
  __syncthreads();
  for (int j = m - 2; j >= 0; --j) {
    gemm(rowmajor(Tw, r), rowmajor(f + bm + j * kk, k), rowmajor(xw + (j + 1) * kr, r),
         rowmajor(xw + j * kr, r), C(-1), k, k, r);
    __syncthreads();
    gemm(rowmajor(xw + j * kr, r), rowmajor(sinv + bm + j * kk, k), rowmajor(Tw, r), none<C>(),
         C(1), k, k, r);
    __syncthreads();
  }
  if (!same) block_copy<C>(rowmajor(x + bv, r), rowmajor(xw, r), m * k, r);
}

namespace {

constexpr int kChunkRows = 16;            // rows of a ring chunk: one a warp
constexpr int kChunkBytesMax = 32 * 1024;  // fewer rows a chunk above K = 512 (float32)
constexpr int kRingMax = 8;               // stages
constexpr int kBars = kRingMax + 2;
// lane 0 of the last warp starts the ring's TMA copies: at P = 8 that warp
// has no row, so the copies stay off the sweep's critical path
constexpr int kProducer = kClusterThreads - 32;
constexpr int kMaxK = 1024;            // larger blocks take the one-block kernel
// shared bytes a CTA may take so that two fit on an SM (228 KB, 1 KB of it
// reserved per CTA)
constexpr size_t kTwoPerSm = 112 * 1024;

__host__ __device__ inline int rmax_of(int r) { return r == 1 ? 1 : r <= 4 ? 4 : 8; }
template <typename T>
__host__ __device__ inline int chunk_rows(int k) {
  return imin(kChunkRows, imax(1, kChunkBytesMax / (int)sizeof(T) / k));
}
// elements of T a ring stage holds: a chunk, rounded up to 16 bytes
template <typename T>
__host__ __device__ inline int stage_elems(int k) {
  constexpr int q = 16 / (int)sizeof(T);
  return (chunk_rows<T>(k) * k + q - 1) / q * q;
}

// Shared bytes besides the ring: the mbarriers and two vector slots
// (K x RMAX of the compute type).
template <typename T>
inline size_t fixed_bytes(int k, int r) {
  return (size_t)kBars * 8 + sizeof(Compute<T>) * 2 * (size_t)k * rmax_of(r);
}

// Ring stages for (K, R): as many as fit beside the fixed part within
// kTwoPerSm, at most kRingMax; when fewer than two fit there, as many as the
// opt-in maximum holds.  0 when two stages do not fit at all.
template <typename T>
inline int ring_stages(int k, int r) {
  const size_t fixed = fixed_bytes<T>(k, r), stage = sizeof(T) * stage_elems<T>(k);
  const size_t budgets[2] = {kTwoPerSm, (size_t)smem_optin()};
  for (size_t budget : budgets) {
    if (budget <= fixed) continue;
    const int s = (int)imin(kRingMax, (int)((budget - fixed) / stage));
    if (s >= 2) return s;
  }
  return 0;
}

template <typename T>
inline size_t cluster_smem(int k, int r) {
  return fixed_bytes<T>(k, r) + sizeof(T) * (size_t)ring_stages<T>(k, r) * stage_elems<T>(k);
}

// ---- PTX helpers: DSMEM pushes (mbarriers and bulk copies: gj_cluster.cuh) ----

// v into the peer CTA's shared memory at the cluster address `dst`,
// completing its bytes on the peer's mbarrier at cluster address `bar`
__device__ inline void push(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(dst),
               "f"(v), "r"(bar)
               : "memory");
}
__device__ inline void push(uint32_t dst, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n" ::"r"(dst),
               "d"(v), "r"(bar)
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
// threads; `stages` ring stages (ring_stages); bulk: TMA copies (rows of a
// multiple of 16 bytes, 16-byte aligned blocks) or element copies.  RMAX:
// 1, 4 or 8 >= R, the vector slots' row stride.  ws: the sweep's y in C
// (M x K x R a chain) when T != C, else unused (y lives in x).
template <int RMAX, typename T>
__global__ void __launch_bounds__(kClusterThreads, 2)
    bts_cluster_kernel(const T* __restrict__ sinv, const T* __restrict__ l,
                       const T* __restrict__ f, const T* __restrict__ b, T* x,
                       Compute<T>* ws, int m, int k, int r, int stages, int bulk) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = slab_rows(k, cs), row0 = rank * n, nrows = max(0, min(n, k - row0));
  const int cr = chunk_rows<T>(k), sel = stage_elems<T>(k);
  const int nch = (nrows + cr - 1) / cr;  // chunks of a block (0 for a CTA past K)
  const int nmat = 3 * m - 2, total = nmat * nch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [stages]: chunk landed
  uint64_t* vbar = full + kRingMax;                          // [2]: slot received
  T* ring = reinterpret_cast<T*>(smem_raw + kBars * 8);
  C* slot0 = reinterpret_cast<C*>(ring + stages * sel);  // two K x RMAX vector slots
  const long kk = (long)k * k, kr = (long)k * r, chain = (long)(blockIdx.x / cs) * m;
  const T* bc = b + chain * kr;
  T* xc = x + chain * kr;
  C* yc = same ? reinterpret_cast<C*>(xc) : ws + chain * kr;  // the sweep's y

  // the block of product t
  auto block_of = [&](int t) -> const T* {
    if (t < m - 1) return l + (chain + t + 1) * kk;
    if (t == m - 1) return sinv + (chain + m - 1) * kk;
    const int u = t - m, j = m - 2 - u / 2;
    return ((u & 1) ? sinv : f) + (chain + j) * kk;
  };
  // chunk q of the stream into stage q % stages
  auto fetch = [&](int q) {
    const int t = q / nch, c = q - t * nch, st = q % stages;
    const int rows = min(cr, nrows - c * cr);
    const T* src = block_of(t) + (long)(row0 + c * cr) * k;
    T* dst = ring + st * sel;
    if (bulk) {
      if (tid == kProducer) {
        mbar_expect_tx(&full[st], (uint32_t)(rows * k * sizeof(T)));
        bulk_copy(dst, src, (uint32_t)(rows * k * sizeof(T)), &full[st]);
      }
    } else if constexpr (sizeof(T) >= 4) {
      for (int e = tid; e < rows * k; e += kClusterThreads) cp_async_elem(dst + e, src + e);
      cp_async_arrive(&full[st]);
    } else {
      for (int e = tid; e < rows * k; e += kClusterThreads) dst[e] = src[e];
      mbar_arrive(&full[st]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], bulk ? 1 : kClusterThreads);
    mbar_init(&vbar[0], 1);
    mbar_init(&vbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // y_0 = b_0: all of it into slot 0, this CTA's rows into y_0; the slots'
  // padding columns zero
  for (int e = tid; e < 2 * k * RMAX; e += kClusterThreads) {
    const int s = e / RMAX, c = e - s * RMAX;
    slot0[e] = s < k && c < r ? conv<C>(bc[s * r + c]) : C(0);
  }
  for (int e = tid; e < nrows * r; e += kClusterThreads) yc[row0 * r + e] = conv<C>(bc[row0 * r + e]);
  cluster.sync();  // the peers are running, the mbarriers initialised, y_0 written
  for (int q = 0; q < min(stages, total); ++q) fetch(q);

  int q = 0;  // chunks consumed
  for (int t = 0; t < nmat; ++t) {
    const bool fwd = t < m - 1, has_base = fwd || (t >= m && ((t - m) & 1) == 0);
    const bool last = t == nmat - 1;
    // the output's rows (y in yc, x in x; none for T), its base (b_{t+1},
    // or y_j in yc, written by this CTA before an earlier barrier) and its
    // sign
    const long jb = (long)(m - 2 - (t - m) / 2) * kr;
    C* out_y = fwd ? yc + (t + 1) * kr : nullptr;
    T* out_x = fwd ? nullptr : t == m - 1 ? xc + (m - 1) * kr : (((t - m) & 1) ? xc + jb : nullptr);
    const C sign = has_base ? C(-1) : C(1);
    const C* vin = slot0 + (t & 1) * k * RMAX;
    C* vout = slot0 + ((t + 1) & 1) * k * RMAX;
    // the warp's base values of its row in chunk c, loaded before the waits
    C bv[RMAX];
    auto load_base = [&](int c) {
      const int i = c * cr + warp;
      if (has_base && c < nch && warp < min(cr, nrows - c * cr)) {
        const long at = (long)(row0 + i) * r;
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc)
          bv[cc] = cc >= r ? C(0) : fwd ? conv<C>(bc[(t + 1) * kr + at + cc]) : yc[jb + at + cc];
      }
    };
    load_base(0);
    if (t > 0) mbar_wait(&vbar[t & 1], ((t - 1) >> 1) & 1);  // exchange: v_t has arrived
    if (!last && tid == kProducer)
      mbar_expect_tx(&vbar[(t + 1) & 1], (uint32_t)(k * r * sizeof(C)));
    for (int c = 0; c < nch; ++c, ++q) {
      if (c > 0) load_base(c);
      const int st = q % stages;
      mbar_wait(&full[st], (q / stages) & 1);  // ring: chunk q has landed
      const int rows = min(cr, nrows - c * cr);
      if (warp < rows) {
        const int i = c * cr + warp;  // the CTA's row
        const T* a = ring + st * sel + warp * k;
        C acc[RMAX];
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc) acc[cc] = C(0);
#pragma unroll 4
        for (int s = lane; s < k; s += 32) {
          const C av = conv<C>(a[s]);
          if (RMAX == 1) {
            acc[0] = fma(av, vin[s], acc[0]);
          } else {
#pragma unroll
            for (int c4 = 0; c4 < RMAX / 4; ++c4) {
              const V4<C> v = as4(vin + s * RMAX + 4 * c4);
              acc[4 * c4] = fma(av, v.x, acc[4 * c4]);
              acc[4 * c4 + 1] = fma(av, v.y, acc[4 * c4 + 1]);
              acc[4 * c4 + 2] = fma(av, v.z, acc[4 * c4 + 2]);
              acc[4 * c4 + 3] = fma(av, v.w, acc[4 * c4 + 3]);
            }
          }
        }
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[cc] += __shfl_xor_sync(0xffffffffu, acc[cc], o);
        // row i = base - (block row) v, or + for Sinv, at once: lane 0
        // writes it out and lane p pushes it into CTA p's slot, so the next
        // product waits on no barrier of this one
#pragma unroll
        for (int cc = 0; cc < RMAX; ++cc)
          if (cc < r) acc[cc] = (has_base ? bv[cc] : C(0)) + sign * acc[cc];
        if (lane == 0) {
          if (out_y != nullptr)
            for (int cc = 0; cc < r; ++cc) out_y[(long)(row0 + i) * r + cc] = acc[cc];
          if (out_x != nullptr)
            for (int cc = 0; cc < r; ++cc) out_x[(long)(row0 + i) * r + cc] = conv<T>(acc[cc]);
        }
        if (!last)
          for (int p = lane; p < cs; p += 32) {
            const uint32_t dst = cluster_addr(vout + (row0 + i) * RMAX, p);
            const uint32_t bar = cluster_addr(&vbar[(t + 1) & 1], p);
            if constexpr (sizeof(C) == 4 && RMAX > 1) {
              if (r == RMAX) {
#pragma unroll
                for (int c4 = 0; c4 < RMAX / 4; ++c4)
                  push16(dst + 16 * c4,
                         make_float4(acc[4 * c4], acc[4 * c4 + 1], acc[4 * c4 + 2], acc[4 * c4 + 3]),
                         bar);
                continue;
              }
            }
#pragma unroll
            for (int cc = 0; cc < RMAX; ++cc)
              if (cc < r) push(dst + sizeof(C) * cc, acc[cc], bar);
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

template <typename T>
using BtsClusterKernel = void (*)(const T*, const T*, const T*, const T*, T*, Compute<T>*, int,
                                  int, int, int, int);

template <typename T>
BtsClusterKernel<T> cluster_kernel(int r) {
  return r == 1   ? bts_cluster_kernel<1, T>
         : r <= 4 ? bts_cluster_kernel<4, T>
                  : bts_cluster_kernel<8, T>;
}

template <typename T>
bool cluster_route_fits(int k, int r) {
  return r >= 1 && r <= kNarrow && k >= 1 && k <= kMaxK && ring_stages<T>(k, r) >= 2;
}

// TMA bulk copies need 16-byte aligned sources and sizes: rows of a
// multiple of 16 bytes and aligned blocks; otherwise the ring fills by
// element copies.
template <typename T>
int bulk_route(const T* sinv, const T* l, const T* f, int k) {
  auto aligned = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  return (k * sizeof(T)) % 16 == 0 && aligned(sinv) && aligned(l) && aligned(f);
}

template <typename T>
int cluster_size_t(int p, int k, int r) {
  if (p <= 0 || k <= 0 || r <= 0) return -(int)cudaErrorInvalidValue;
  if (!cluster_route_fits<T>(k, r)) return 0;
  return grow_cluster(cluster_kernel<T>(r), p, 1, [k, r](int) { return cluster_smem<T>(k, r); });
}

template <typename T>
int launch_t(const T* sinv, const T* l, const T* f, const T* b, T* x, Compute<T>* ws, int p,
             int m, int k, int r, int cluster, void* stream) {
  if (p <= 0 || m <= 0 || k <= 0 || r <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  if (ws_per_chain<T>(m, k, r, cluster) > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    bts_kernel<T><<<p, kThreads, 0, (cudaStream_t)stream>>>(sinv, l, f, b, x, ws, m, k, r);
    return (int)cudaGetLastError();
  }
  if (!cluster_route_fits<T>(k, r)) return (int)cudaErrorInvalidValue;
  const int stages = ring_stages<T>(k, r);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem<T>(k, r);
  const BtsClusterKernel<T> kern = cluster_kernel<T>(r);
  const int active = max_active_clusters(kern, cluster, smem);
  if (active < 0) return -active;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  const int bulk = bulk_route(sinv, l, f, k);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(p * cluster), cluster, smem, (cudaStream_t)stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, sinv, l, f, b, x, ws, m, k, r, stages, bulk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// For each storage type (SAP_DTYPE_ENTRIES: bts_launch, bts_launch_bf16,
// bts_launch_f64, and the same suffixes on the others):
//
// bts_cluster_size: the cluster size a bts launch of P chains of K x K
// blocks with R right-hand sides takes: 1..16, or 0 for the one-block
// kernel (R > 8, or blocks whose ring does not fit); a negative
// cudaError_t code on failure.
//
// bts_ring_stages: the ring stages of a cluster launch (for the record).
//
// bts_workspace_floats: elements of the compute type of device workspace
// each partition of M block rows needs on the route of a cluster size: the
// sweep's y (M K R) for bfloat16, and T (K R) on the one-block route.
//
// bts_launch: cluster is the size bts_cluster_size gives, or (tests) any
// size 1..16; 0 launches the one-block kernel.  A route that does not fit
// the shape, or a size the card cannot schedule, is an error, never a
// fallback.
//
// bts_bulk_route: whether a cluster launch of these operands takes the TMA
// bulk copies (1) or element copies (0).
#define BTS_ENTRIES(T, SUF, C)                                                                   \
  extern "C" int bts_cluster_size##SUF(int p, int k, int r) { return cluster_size_t<T>(p, k, r); } \
  extern "C" int bts_ring_stages##SUF(int k, int cluster, int r) {                               \
    return cluster_route_fits<T>(k, r) && cluster >= 1 ? ring_stages<T>(k, r) : 0;              \
  }                                                                                              \
  extern "C" long bts_workspace_floats##SUF(int m, int k, int r, int cluster) {                  \
    return ws_per_chain<T>(m, k, r, cluster);                                                    \
  }                                                                                              \
  extern "C" int bts_launch##SUF(const T* sinv, const T* l, const T* f, const T* b, T* x, C* ws, \
                                 int p, int m, int k, int r, int cluster, void* stream) {        \
    return launch_t<T>(sinv, l, f, b, x, ws, p, m, k, r, cluster, stream);                       \
  }                                                                                              \
  extern "C" int bts_bulk_route##SUF(const T* sinv, const T* l, const T* f, int k) {             \
    return bulk_route<T>(sinv, l, f, k);                                                         \
  }
SAP_DTYPE_ENTRIES(BTS_ENTRIES)
