// Block cyclic reduction of one block-tridiagonal chain (the SaP-E reduced
// interface system): four kernels, launched once (or twice) per level.
//
// Replaces the TPU kernels of repro/kernels/bcr.py:
//   inv_kernel        <- _inv_odd_kernel     a_i = inv(D_{2i+1}) (boosted GJ)
//   reduce_*_kernel   <- _reduce_kernel      lo, hi, then D', E', F'
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
//   * reduce: a shared-memory tiled product, 64 x 64 output tiles of
//     C = base + sign (A1 B1 + A2 B2) with 16-deep K slices, 256 threads
//     and a 4 x 4 register tile each; the grid is (tiles, product, row), so
//     level 0 at P = 64 runs 32 rows x 2 (then 3) products x 49 tiles.
//     Two launches: lo and hi first, since D', E', F' read them.
//   * rhs_reduce / backsub: 64 output rows per thread block, the warps
//     reading rows of the K x K blocks with consecutive lanes (the narrow
//     product of common.cuh; the tiled one for R > 8).  backsub forms
//     t = b_odd - e x_i - f x_i+1 in a workspace in one launch and
//     x_odd = a t with the interleave in a second, since a t needs all of t.
// All arithmetic is float32 FMA on the CUDA cores: no tensor cores, no TF32.
#include "gj_cluster.cuh"

using namespace sap;

namespace {

constexpr int kTile = 64;       // output tile of the tiled product (rows and columns)
constexpr int kSlice = 16;      // K-slice depth per shared-memory stage
constexpr int kTileThreads = 256;
constexpr int kRows = 64;       // output rows per block of the narrow kernels

// One kTile x kTile output tile at (r0, c0) of
//   C = base + sign * (A1 @ B1 + A2 @ B2)
// with A* n x q and B* q x r row-major, C and base n x r row-major; A2 ==
// nullptr drops the second product, base == nullptr means zero.  Thread
// (ty, tx) of a 16 x 16 grid owns rows r0 + 4 ty .. +3 and columns
// c0 + 4 tx .. +3; the slices of A are stored transposed so both operands
// are read as float4 from shared memory.
__device__ void tile_product(float* C, const float* base, float sign, const float* A1,
                             const float* B1, const float* A2, const float* B2, int n, int q,
                             int r, int r0, int c0) {
  __shared__ __align__(16) float As[kSlice][kTile + 4];
  __shared__ __align__(16) float Bs[kSlice][kTile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int p = 0; p < 2; ++p) {
    const float* A = p ? A2 : A1;
    const float* B = p ? B2 : B1;
    if (A == nullptr) break;  // uniform across the block
    for (int k0 = 0; k0 < q; k0 += kSlice) {
      for (int e = tid; e < kTile * kSlice; e += kTileThreads) {
        const int mm = e / kSlice, kk = e % kSlice;
        const int gr = r0 + mm, gk = k0 + kk;
        As[kk][mm] = (gr < n && gk < q) ? A[(long)gr * q + gk] : 0.f;
      }
      for (int e = tid; e < kSlice * kTile; e += kTileThreads) {
        const int kk = e / kTile, nn = e % kTile;
        const int gk = k0 + kk, gc = c0 + nn;
        Bs[kk][nn] = (gk < q && gc < r) ? B[(long)gk * r + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + 4 * ty + a;
    if (row >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = c0 + 4 * tx + b;
      if (col < r) {
        const long at = (long)row * r + col;
        C[at] = (base ? base[at] : 0.f) + sign * acc[a][b];
      }
    }
  }
}

__device__ inline int tiles_per_side(int k) { return (k + kTile - 1) / kTile; }

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

// lo_i = E_2i a_max(i-1,0) (y = 0),  hi_i = F_2i a_i (y = 1); grid (tiles, 2, m2).
__global__ void __launch_bounds__(kTileThreads)
    reduce_lohi_kernel(const float* __restrict__ e, const float* __restrict__ f,
                       const float* __restrict__ a, float* lo, float* hi, int k) {
  const int i = blockIdx.z, nt = tiles_per_side(k);
  const int r0 = (blockIdx.x / nt) * kTile, c0 = (blockIdx.x % nt) * kTile;
  const long kk = (long)k * k;
  if (blockIdx.y == 0)
    tile_product(lo + i * kk, nullptr, 1.f, e + 2L * i * kk, a + (long)max(i - 1, 0) * kk,
                 nullptr, nullptr, k, k, k, r0, c0);
  else
    tile_product(hi + i * kk, nullptr, 1.f, f + 2L * i * kk, a + i * kk, nullptr, nullptr, k, k,
                 k, r0, c0);
}

// D'_i = D_2i - (lo_i F_p + hi_i E_2i+1)  (y = 0),  E'_i = -(lo_i E_p)  (y = 1),
// F'_i = -(hi_i F_2i+1)  (y = 2), with p = max(2i-1, 0); grid (tiles, 3, m2).
__global__ void __launch_bounds__(kTileThreads)
    reduce_chain_kernel(const float* __restrict__ d, const float* __restrict__ e,
                        const float* __restrict__ f, const float* __restrict__ lo,
                        const float* __restrict__ hi, float* dn, float* en, float* fn, int k) {
  const int i = blockIdx.z, nt = tiles_per_side(k);
  const int r0 = (blockIdx.x / nt) * kTile, c0 = (blockIdx.x % nt) * kTile;
  const long kk = (long)k * k;
  const long prv = (long)max(2 * i - 1, 0) * kk, nxt = (2L * i + 1) * kk;
  const float* loi = lo + i * kk;
  const float* hii = hi + i * kk;
  if (blockIdx.y == 0)
    tile_product(dn + i * kk, d + 2L * i * kk, -1.f, loi, f + prv, hii, e + nxt, k, k, k, r0, c0);
  else if (blockIdx.y == 1)
    tile_product(en + i * kk, nullptr, -1.f, loi, e + prv, nullptr, nullptr, k, k, k, r0, c0);
  else
    tile_product(fn + i * kk, nullptr, -1.f, hii, f + nxt, nullptr, nullptr, k, k, k, r0, c0);
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
inline int tiles(int k) { return ((k + kTile - 1) / kTile) * ((k + kTile - 1) / kTile); }
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

extern "C" int bcr_reduce_launch(const float* d, const float* e, const float* f, const float* a,
                                 float* lo, float* hi, float* dn, float* en, float* fn, int m2,
                                 int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  reduce_lohi_kernel<<<dim3(tiles(k), 2, m2), kTileThreads, 0, s>>>(e, f, a, lo, hi, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_chain_kernel<<<dim3(tiles(k), 3, m2), kTileThreads, 0, s>>>(d, e, f, lo, hi, dn, en, fn,
                                                                     k);
  return (int)cudaGetLastError();
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
