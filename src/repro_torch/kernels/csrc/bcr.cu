// Block cyclic reduction of one block-tridiagonal chain (the SaP-E reduced
// interface system): four kernels, launched once (or twice) per level.
//
// Replaces the TPU kernels of repro/kernels/bcr.py:
//   inv_kernel        <- _inv_odd_kernel     a_i = inv(D_{2i+1}) (boosted GJ)
//   reduce_kernel     <- _reduce_kernel      lo, hi, then D', E', F'
//   rhs_reduce_kernel <- _rhs_reduce_kernel  b'_i = b_2i - lo_i b_2i-1 - hi_i b_2i+1
//   backsub_kernel    <- _backsub_kernel     x_2i+1 = a_i (b_2i+1 - e_i x_i - f_i x_i+1)
// The TPU kernels run one grid cell per even row; here every level is a
// grid over (row, output tile), since one level has only m/2 rows (32, 16,
// ..., 1 at P = 64) and one block per row would leave most of the 132 SMs
// idle.  Neighbours are read at the clamped indices max(2i-1, 0) and
// min(i+1, m/2-1), as the TPU kernels' index maps do; the algebra zeroes
// those terms (E_0 = 0, F_{m-1} = 0), and every clamped block is a real,
// initialised block of the same tensor.  No lane padding: the (8, 128)
// tiles were the TPU's.
//
// Bound: the factor is operation-bound (six (2K)^3 products and one
// inverse per eliminated row, ~14 (2K)^3 flops on ~16 blocks moved); the
// solve at small R is byte-bound (each apply reads lo, hi, a, e, f once).
// Design:
//   * inv_cluster_kernel: one thread-block cluster per inverted block, the
//     block resident in the cluster's distributed shared memory (below).
//   * inv_kernel: one thread block per inverted block, for blocks too large
//     for a 16-CTA cluster (and, by the wrapper's choice, for blocks that
//     fit one block's shared memory): the block is copied into its output
//     slot and inverted there by the shared boosted Gauss-Jordan
//     (common.cuh), or in shared memory when it fits.
//     Both keep the structural-zero pivot rule: the identity padding
//     inverts to the identity.
//   * reduce_kernel: a staged, register-tiled product (below, kDepth): a
//     CTA a BM x BM output tile, the tile size chosen per level from its
//     shape (bcr_reduce_tile: 64 wide, or 80 / 96 when it pads K by at most
//     5% and the level's grid gives every SM 8 CTAs -- the P = 500 chain's
//     first levels at 2K = 400; chip_smoke.py prints each level's choice).  Two launches a level: lo and hi, then D',
//     E', F', since those read all of lo and hi; in the second a D' tile
//     (two products) and an E' + F' tile pair (one product each) are one
//     CTA each, so every CTA does two products' work.
//   * rhs_reduce / backsub: 64 output rows per thread block, the warps
//     reading rows of the K x K blocks with consecutive lanes (the narrow
//     product of common.cuh; the tiled one for R > 8).  backsub forms
//     t = b_odd - e x_i - f x_i+1 in a workspace in one launch and
//     x_odd = a t with the interleave in a second, since a t needs all of t.
// All arithmetic is float32 FMA on the CUDA cores: no tensor cores, no TF32.
#include "gj_cluster.cuh"

using namespace sap;

namespace {

constexpr int kRows = 64;  // output rows per block of the narrow kernels

// ---- reduce: staged, register-tiled K x K products -------------------------
//
// A CTA computes one BM x BM output tile of a K x K product
// C = base + sign * (A1 B1 [+ A2 B2]).  The depth (both products' in turn)
// streams in slices of kDepth through kStages shared-memory buffers by
// cp.async, 16 bytes at a time when K % 4 == 0 (4 bytes otherwise), two
// slices in flight while a third is multiplied, one barrier a slice.
// Both slices keep the global layout: A's kDepth-wide row pieces, so a
// thread reads four depths of one of its rows as a float4, and B's rows.
// (Staged transposed, A took 4-byte copies whose instructions cost more
// cycles than the FMAs: tools/kernel_phases.py.)  Each thread keeps an 8 x TN
// register tile: rows ty*4..+3 and BM/2 + ty*4..+3, columns tx*4..+3 (a
// float4) and, for TN > 4, the single columns 4 kTx + e kTx + tx, so a
// warp's reads of a slice row are of consecutive addresses and every CTA
// is whole warps (8 x 6 at 96, 8 x 5 at 80, 8 x 4 at 64 and 32).  Edges
// past K read zeros and are not stored.
constexpr int kDepth = 16;
constexpr int kStages = 3;
// the tile sizes a launch may take: 96, 80, 64, 32 (reduce_tile_for)

template <int BM>
struct TileShape {
  static constexpr int TN = BM == 96 ? 6 : BM == 80 ? 5 : 4;
  static constexpr int kTx = BM / TN, kTy = BM / 8, kThreads = kTx * kTy;
  static constexpr int kLdA = kDepth + 4;  // row stride of the A slice
  static constexpr int kStageFloats = BM * kLdA + kDepth * BM;
  static_assert(kTx * TN == BM && kThreads % 32 == 0, "a tile is whole warps");
  // column j of thread tx's register tile
  __device__ static int col(int tx, int j) { return j < 4 ? tx * 4 + j : (j * kTx) + tx; }
};

// Stage slice s of the sequence (A1 B1's ns slices, then A2 B2's) into buf.
template <int BM>
__device__ inline void stage_tile_slice(float* buf, const float* A1, const float* B1,
                                        const float* A2, const float* B2, int k, int ns, int s,
                                        int r0, int c0, bool vec) {
  using TS = TileShape<BM>;
  const float* A = s < ns ? A1 : A2;
  const float* B = s < ns ? B1 : B2;
  const int k0 = (s < ns ? s : s - ns) * kDepth;
  float* as = buf;
  float* bs = buf + BM * TS::kLdA;
  if (vec) {
    for (int e = threadIdx.x; e < BM * (kDepth / 4); e += TS::kThreads) {
      const int i = e / (kDepth / 4), kk = 4 * (e - i * (kDepth / 4)), row = r0 + i, col = k0 + kk;
      float* dst = as + i * TS::kLdA + kk;
      if (row < k && col < k)
        cp_async16(dst, A + (long)row * k + col);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < BM * kDepth; e += TS::kThreads) {
      const int i = e / kDepth, kk = e - i * kDepth, row = r0 + i, col = k0 + kk;
      float* dst = as + i * TS::kLdA + kk;
      if (row < k && col < k)
        cp_async4(dst, A + (long)row * k + col);
      else
        *dst = 0.f;
    }
  }
  if (vec) {
    for (int e = threadIdx.x; e < kDepth * (BM / 4); e += TS::kThreads) {
      const int kk = e / (BM / 4), j = 4 * (e - kk * (BM / 4)), row = k0 + kk, col = c0 + j;
      float* dst = bs + kk * BM + j;
      if (row < k && col < k)
        cp_async16(dst, B + (long)row * k + col);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < kDepth * BM; e += TS::kThreads) {
      const int kk = e / BM, j = e - kk * BM, row = k0 + kk, col = c0 + j;
      float* dst = bs + kk * BM + j;
      if (row < k && col < k)
        cp_async4(dst, B + (long)row * k + col);
      else
        *dst = 0.f;
    }
  }
}

// acc = A1 B1 (+ A2 B2 when A2 != nullptr) on the tile at (r0, c0).
template <int BM>
__device__ inline void tile_gemm(float* smem, float (&acc)[8][TileShape<BM>::TN], const float* A1,
                                 const float* B1, const float* A2, const float* B2, int k, int r0,
                                 int c0, bool vec) {
  using TS = TileShape<BM>;
  constexpr int TN = TS::TN;
  const int tx = threadIdx.x % TS::kTx, ty = threadIdx.x / TS::kTx;
  const int ns = (k + kDepth - 1) / kDepth, total = A2 ? 2 * ns : ns;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  stage_tile_slice<BM>(smem, A1, B1, A2, B2, k, ns, 0, r0, c0, vec);
  cp_async_commit();
  if (total > 1)
    stage_tile_slice<BM>(smem + TS::kStageFloats, A1, B1, A2, B2, k, ns, 1, r0, c0, vec);
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    cp_async_wait<1>();  // staging: slice s has landed
    __syncthreads();     // ... for every thread; slice s-1's buffer is free
    if (s + 2 < total)
      stage_tile_slice<BM>(smem + ((s + 2) % kStages) * TS::kStageFloats, A1, B1, A2, B2, k, ns,
                           s + 2, r0, c0, vec);
    cp_async_commit();
    const float* as = smem + (s % kStages) * TS::kStageFloats;
    const float* bs = as + BM * TS::kLdA;
#pragma unroll
    for (int k4 = 0; k4 < kDepth; k4 += 4) {
      float4 a4[8];  // depths k4..k4+3 of the thread's eight rows
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a4[i] = *reinterpret_cast<const float4*>(
            as + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4) * TS::kLdA + k4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = k4 + u;
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BM + tx * 4);
        float bv[TN];
        bv[0] = b0.x;
        bv[1] = b0.y;
        bv[2] = b0.z;
        bv[3] = b0.w;
#pragma unroll
        for (int j = 4; j < TN; ++j) bv[j] = bs[kk * BM + TS::col(tx, j)];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = u == 0 ? a4[i].x : u == 1 ? a4[i].y : u == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // the buffers are free for the caller's next tile_gemm
}

// C = base + sign * acc on the tile at (r0, c0); base == nullptr means zero.
template <int BM>
__device__ inline void tile_store(float* C, const float* base, float sign,
                                  const float (&acc)[8][TileShape<BM>::TN], int k, int r0, int c0,
                                  bool vec) {
  using TS = TileShape<BM>;
  const int tx = threadIdx.x % TS::kTx, ty = threadIdx.x / TS::kTx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (row >= k) continue;
    const long at = (long)row * k + c0;
    const int c4 = tx * 4;
    if (vec && c0 + c4 < k) {  // K % 4 == 0: the four columns are in range
      float4 v = base ? *reinterpret_cast<const float4*>(base + at + c4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      v.x += sign * acc[i][0];
      v.y += sign * acc[i][1];
      v.z += sign * acc[i][2];
      v.w += sign * acc[i][3];
      *reinterpret_cast<float4*>(C + at + c4) = v;
    } else if (!vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + c4 + j < k) C[at + c4 + j] = (base ? base[at + c4 + j] : 0.f) + sign * acc[i][j];
    }
#pragma unroll
    for (int j = 4; j < TS::TN; ++j) {
      const int c = TS::col(tx, j);
      if (c0 + c < k) C[at + c] = (base ? base[at + c] : 0.f) + sign * acc[i][j];
    }
  }
}

}  // namespace

// dst[i] = inv(src[first + 2 i]) by boosted Gauss-Jordan; grid (count).
__global__ void __launch_bounds__(kThreads)
    inv_kernel(const float* __restrict__ src, float* dst, int first, int k, float boost_eps,
               int w_in_smem) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rowbuf = red + kRed;
  float* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  float* out = dst + blockIdx.x * kk;
  float* W = w_in_smem ? colbuf + k : out;
  block_copy(rowmajor(W, k), rowmajor(src + (first + 2L * blockIdx.x) * kk, k), k, k);
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  if (w_in_smem) {
    block_copy(rowmajor(out, k), rowmajor(W, k), k, k);
  }
}

// dst[i] = inv(src[first + 2 i]) by boosted Gauss-Jordan on a cluster of
// cs CTAs per block; grid (count * cs), cluster (cs), kClusterThreads
// threads.
//
// Bound: 2 K^3 float32 operations a block (0.1223 ms for the 64 blocks of
// 400 x 400 of the P = 64 interface chain, H100 at 67 TFLOP/s); inverting
// one block per thread block left the deep levels, which have one or two
// blocks, on one or two SMs, streaming the block through L2 at every
// column.  Here the block lives in the cluster's shared memory, CTA r
// owning the rows [r R, r R + R), R = ceil(K / cs), and is inverted by the
// blocked Gauss-Jordan of gj_cluster.cuh (gj_cluster_inverse), in panels of
// kPanel columns whose pivot rows travel by DSMEM.

// shared bytes of one CTA: the slab and the elimination's scratch
inline size_t cluster_smem_bytes(int k, int cs) { return slab_smem_bytes(k, cs, false); }

// NC: columns a thread owns in the strip (c = threadIdx.x + n
// kClusterThreads, n < NC)
template <int NC>
__global__ void __launch_bounds__(kClusterThreads)
    inv_cluster_kernel(const float* __restrict__ src, float* __restrict__ dst, int first, int k,
                       float boost_eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  extern __shared__ __align__(16) float smem[];
  const Slab s = make_slab(smem, k, cs, (int)cluster.block_rank(), false);
  const int tid = threadIdx.x, ld = s.ld, row0 = s.row0, nrows = s.nrows;
  float* slab = s.w;
  const long kk = (long)k * k;
  const float* a = src + (first + 2L * (blockIdx.x / cs)) * kk;
  float* out = dst + (long)(blockIdx.x / cs) * kk;

  // this CTA's rows are contiguous in the row-major block: 8 loads in flight a thread
  float mx = 0.f;
  const float* mine = a + (long)row0 * k;
  for (int e0 = 0; e0 < nrows * k; e0 += 8 * kClusterThreads) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kClusterThreads + tid;
      x[u] = e < nrows * k ? mine[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kClusterThreads + tid;
      if (e < nrows * k) slab[(e / k) * ld + e % k] = x[u];
      mx = fmaxf(mx, fabsf(x[u]));
    }
  }
  const float scale = cluster_max(cluster, mx, s.red);  // slabs and maxima visible to the cluster
  gj_cluster_inverse<NC>(cluster, s, boost_eps * fmaxf(scale, 1e-30f));
  for (int e = tid; e < nrows * k; e += kClusterThreads) {
    const int r = e / k, c = e - r * k;
    out[(long)(row0 + r) * k + c] = slab[r * ld + c];
  }
}

// phase 0: lo_i = E_2i a_max(i-1,0) (y = 0), hi_i = F_2i a_i (y = 1);
// phase 1: D'_i = D_2i - (lo_i F_p + hi_i E_2i+1) (y = 0), and E'_i =
// -(lo_i E_p) then F'_i = -(hi_i F_2i+1) (y = 1), p = max(2i-1, 0), so every
// CTA of a launch does the same work.  Grid (tiles, 2, m2).
template <int BM>
__global__ void __launch_bounds__(TileShape<BM>::kThreads)
    reduce_kernel(const float* __restrict__ d, const float* __restrict__ e,
                  const float* __restrict__ f, const float* __restrict__ a, float* lo, float* hi,
                  float* dn, float* en, float* fn, int k, int phase) {
  __shared__ __align__(16) float smem[kStages * TileShape<BM>::kStageFloats];
  const int i = blockIdx.z, nt = (k + BM - 1) / BM;
  const int r0 = (blockIdx.x / nt) * BM, c0 = (blockIdx.x % nt) * BM;
  const long kk = (long)k * k;
  const bool vec = (k & 3) == 0;
  float acc[8][TileShape<BM>::TN];
  if (phase == 0) {
    const bool is_lo = blockIdx.y == 0;
    tile_gemm<BM>(smem, acc, (is_lo ? e : f) + 2L * i * kk,
                  a + (long)(is_lo ? max(i - 1, 0) : i) * kk, nullptr, nullptr, k, r0, c0, vec);
    tile_store<BM>((is_lo ? lo : hi) + i * kk, nullptr, 1.f, acc, k, r0, c0, vec);
    return;
  }
  const long prv = (long)max(2 * i - 1, 0) * kk, nxt = (2L * i + 1) * kk;
  const float* loi = lo + i * kk;
  const float* hii = hi + i * kk;
  if (blockIdx.y == 0) {
    tile_gemm<BM>(smem, acc, loi, f + prv, hii, e + nxt, k, r0, c0, vec);
    tile_store<BM>(dn + i * kk, d + 2L * i * kk, -1.f, acc, k, r0, c0, vec);
  } else {
    tile_gemm<BM>(smem, acc, loi, e + prv, nullptr, nullptr, k, r0, c0, vec);
    tile_store<BM>(en + i * kk, nullptr, -1.f, acc, k, r0, c0, vec);
    tile_gemm<BM>(smem, acc, hii, f + nxt, nullptr, nullptr, k, r0, c0, vec);
    tile_store<BM>(fn + i * kk, nullptr, -1.f, acc, k, r0, c0, vec);
  }
}

// out_i = b_2i - lo_i b_max(2i-1,0) - hi_i b_2i+1 for rows r0..r0+63 of
// block i; grid (row tiles, m2).
__global__ void __launch_bounds__(kThreads)
    rhs_reduce_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                      const float* __restrict__ b, float* out, int k, int r) {
  const int i = blockIdx.y, r0 = blockIdx.x * kRows, n = min(kRows, k - r0);
  const long kk = (long)k * k, kr = (long)k * r;
  const float* bp = b + (long)max(2 * i - 1, 0) * kr;
  const float* bn = b + (2L * i + 1) * kr;
  float* o = out + i * kr + (long)r0 * r;
  gemm(rowmajor(o, r), rowmajor(lo + i * kk + (long)r0 * k, k), rowmajor(bp, r),
       rowmajor(b + 2L * i * kr + (long)r0 * r, r), -1.f, n, k, r);
  __syncthreads();
  gemm(rowmajor(o, r), rowmajor(hi + i * kk + (long)r0 * k, k), rowmajor(bn, r), rowmajor(o, r),
       -1.f, n, k, r);
}

// phase 0: t_i = b_2i+1 - e_i x_i - f_i x_min(i+1,m2-1);
// phase 1: out_2i = x_i, out_2i+1 = a_i t_i.  Grid (row tiles, m2).
__global__ void __launch_bounds__(kThreads)
    backsub_kernel(const float* __restrict__ a, const float* __restrict__ e,
                   const float* __restrict__ f, const float* __restrict__ b,
                   const float* __restrict__ x, float* t, float* out, int k, int r, int m2,
                   int phase) {
  const int i = blockIdx.y, r0 = blockIdx.x * kRows, n = min(kRows, k - r0);
  const long kk = (long)k * k, kr = (long)k * r, rows = i * kk + (long)r0 * k;
  const long sub = (long)r0 * r;
  float* ti = t + i * kr + sub;
  if (phase == 0) {
    gemm(rowmajor(ti, r), rowmajor(e + rows, k), rowmajor(x + i * kr, r),
         rowmajor(b + (2L * i + 1) * kr + sub, r), -1.f, n, k, r);
    __syncthreads();
    gemm(rowmajor(ti, r), rowmajor(f + rows, k), rowmajor(x + (long)min(i + 1, m2 - 1) * kr, r),
         rowmajor(ti, r), -1.f, n, k, r);
  } else {
    gemm(rowmajor(out + (2L * i + 1) * kr + sub, r), rowmajor(a + rows, k),
         rowmajor(t + i * kr, r), none(), 1.f, n, k, r);
    block_copy(rowmajor(out + 2L * i * kr + sub, r), rowmajor(x + i * kr + sub, r), n, r);
  }
}

namespace {
inline int row_tiles(int k) { return (k + kRows - 1) / kRows; }
}  // namespace

namespace {

using InvClusterKernel = void (*)(const float*, float*, int, int, float);

// The cluster kernel for K x K blocks on `cluster` CTAs, its launch
// configuration (grid left to the caller) and the clusters the card holds
// at once (cudaOccupancyMaxActiveClusters).  These are host calls of tens
// of microseconds, so each kernel's attributes are set once per device
// (shared memory up to the opt-in maximum, clusters above 8) and the
// occupancy is cached per device, K and cluster size.
cudaError_t cluster_setup(int k, int cluster, InvClusterKernel* kern, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr, int* active) {
  static int attrs_dev[2] = {-1, -1};
  static int cached_dev[kClusterMax + 1], cached_k[kClusterMax + 1] = {},
      cached_active[kClusterMax + 1];
  const int nc = k > kClusterThreads ? 2 : 1;
  *kern = nc == 1 ? inv_cluster_kernel<1> : inv_cluster_kernel<2>;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = cluster_smem_bytes(k, cluster);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (attrs_dev[nc - 1] != dev) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(*kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attrs_dev[nc - 1] = dev;
  }
  if (cached_k[cluster] == k && cached_dev[cluster] == dev) {
    *active = cached_active[cluster];
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveClusters(active, *kern, cfg);
  if (err != cudaSuccess) return err;
  cached_k[cluster] = k;
  cached_dev[cluster] = dev;
  cached_active[cluster] = *active;
  return cudaSuccess;
}

}  // namespace

// cluster > 0: inv_cluster_kernel on clusters of that many CTAs (at most
// kClusterMax; K <= 2 kClusterThreads); cluster == 0: inv_kernel, one
// block per inverted block.  A cluster size the card cannot schedule, or a
// slab that does not fit, is an error, never a fallback.
extern "C" int bcr_inv_launch(const float* src, float* dst, int count, int first, int k,
                              float boost_eps, int cluster, void* stream) {
  if (count <= 0 || k <= 0 || cluster < 0 || cluster > kClusterMax ||
      (cluster > 0 && k > 2 * kClusterThreads))
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    int w_in_smem = 0;
    const size_t smem = gj_smem_bytes(k, &w_in_smem);
    cudaError_t err =
        cudaFuncSetAttribute(inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    inv_kernel<<<count, kThreads, smem, (cudaStream_t)stream>>>(src, dst, first, k, boost_eps,
                                                                w_in_smem);
    return (int)cudaGetLastError();
  }
  InvClusterKernel kern;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err = cluster_setup(k, cluster, &kern, &cfg, &attr, &active);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(count * cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kern, src, dst, first, k, boost_eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of `cluster` CTAs the card can hold at once for K x K blocks
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t code.
extern "C" int bcr_inv_max_clusters(int k, int cluster) {
  if (k <= 0 || cluster < 1 || cluster > kClusterMax || k > 2 * kClusterThreads)
    return -(int)cudaErrorInvalidValue;
  InvClusterKernel kern;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  const cudaError_t err = cluster_setup(k, cluster, &kern, &cfg, &attr, &active);
  return err == cudaSuccess ? active : -(int)err;
}

namespace {

// The tile size of a reduce level of m2 rows of K x K blocks.  The
// 64-wide tile (128 threads, four CTAs an SM) was the fastest on the H100
// at every level measured but the widest, its ragged edge included; the
// 80- and 96-wide tiles do more multiply-adds a load (8 x 5, 8 x 6) but
// hold two CTAs an SM, so they pay only on a grid that gives every SM
// many CTAs.  So: the largest of 96 and 80 that pads K by at most 5% and
// whose launch of 2 m2 tiles^2 CTAs gives every SM at least 8, else 64;
// 32 when K <= 32, where a 64-wide tile would be mostly padding.
int reduce_tile_for(int m2, int k, int sms) {
  if (k <= 32) return 32;
  const int wide[2] = {96, 80};
  for (const int t : wide) {
    const long nt = (k + t - 1) / t;
    if (nt * t * 100 <= 105L * k && 2L * m2 * nt * nt >= 8L * sms) return t;
  }
  return 64;
}

template <int BM>
cudaError_t launch_reduce(const float* d, const float* e, const float* f, const float* a,
                          float* lo, float* hi, float* dn, float* en, float* fn, int m2, int k,
                          cudaStream_t s) {
  const int nt = (k + BM - 1) / BM;
  const dim3 grid(nt * nt, 2, m2);
  for (int phase = 0; phase < 2; ++phase) {  // D', E', F' read all of lo and hi
    reduce_kernel<BM><<<grid, TileShape<BM>::kThreads, 0, s>>>(d, e, f, a, lo, hi, dn, en, fn, k,
                                                                phase);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The tile size a reduce level of m2 rows of K x K blocks takes on the
// current device (reduce_tile_for), or a negative cudaError_t code.
extern "C" int bcr_reduce_tile(int m2, int k) {
  if (m2 <= 0 || k <= 0) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  return reduce_tile_for(m2, k, sms);
}

// tile: 0 takes bcr_reduce_tile's choice; (tests) 96, 80, 64 or 32
// forces it.  Two launches, lo and hi first.
extern "C" int bcr_reduce_launch(const float* d, const float* e, const float* f, const float* a,
                                 float* lo, float* hi, float* dn, float* en, float* fn, int m2,
                                 int k, int tile, void* stream) {
  if (m2 <= 0 || k <= 0 || tile < 0) return (int)cudaErrorInvalidValue;
  if (tile == 0) {
    tile = bcr_reduce_tile(m2, k);
    if (tile < 0) return -tile;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 96: return (int)launch_reduce<96>(d, e, f, a, lo, hi, dn, en, fn, m2, k, s);
    case 80: return (int)launch_reduce<80>(d, e, f, a, lo, hi, dn, en, fn, m2, k, s);
    case 64: return (int)launch_reduce<64>(d, e, f, a, lo, hi, dn, en, fn, m2, k, s);
    case 32: return (int)launch_reduce<32>(d, e, f, a, lo, hi, dn, en, fn, m2, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int bcr_rhs_reduce_launch(const float* lo, const float* hi, const float* b, float* out,
                                     int m2, int k, int r, void* stream) {
  rhs_reduce_kernel<<<dim3(row_tiles(k), m2), kThreads, 0, (cudaStream_t)stream>>>(lo, hi, b, out,
                                                                                  k, r);
  return (int)cudaGetLastError();
}

extern "C" int bcr_backsub_launch(const float* a, const float* e, const float* f, const float* b,
                                  const float* x, float* t, float* out, int m2, int k, int r,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int phase = 0; phase < 2; ++phase) {
    backsub_kernel<<<dim3(row_tiles(k), m2), kThreads, 0, s>>>(a, e, f, b, x, t, out, k, r, m2,
                                                               phase);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The cluster size that inverts K x K blocks on the current device: the
// smallest power of two up to kClusterMax whose slab (cluster_smem_bytes)
// fits the shared memory one block may opt in to; 0 when none does, or K
// exceeds the columns a cluster's threads own -- the one-block kernel then
// inverts in device memory.  A negative cudaError_t code on failure.
extern "C" int bcr_inv_cluster_size(int k) {
  if (k <= 0) return -(int)cudaErrorInvalidValue;
  if (k > 2 * kClusterThreads) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  for (int cs = 1; cs <= kClusterMax; cs *= 2)
    if (cluster_smem_bytes(k, cs) <= (size_t)optin) return cs;
  return 0;
}
