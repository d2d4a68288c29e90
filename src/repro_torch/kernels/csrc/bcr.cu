// Block cyclic reduction of one block-tridiagonal chain (the SaP-E reduced
// interface system): four kernels, launched once (reduce: twice) per level.
//
// Replaces the TPU kernels of repro/kernels/bcr.py:
//   inv_kernel        <- _inv_odd_kernel     a_i = inv(D_{2i+1}) (boosted GJ)
//   reduce_kernel     <- _reduce_kernel      lo, hi, then D', E', F'
//   rhs_reduce_warp_kernel <- _rhs_reduce_kernel  b'_i = b_2i - lo_i b_2i-1 - hi_i b_2i+1
//   backsub_cluster_kernel <- _backsub_kernel     x_2i+1 = a_i (b_2i+1 - e_i x_i - f_i x_i+1)
//   (rhs_reduce_kernel, backsub_kernel: the same for R > 8)
// The TPU kernels run one grid cell per even row; here every level is a
// grid over (row, output tile) or (row slice), since one level has only
// m/2 rows (32, 16, ..., 1 at P = 64) and one block per row would leave
// most of the 132 SMs idle.  Neighbours are read at the clamped indices max(2i-1, 0) and
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
//   * rhs_reduce_warp_kernel (R <= 8): a warp per output row, the rows of
//     lo and hi streamed two ahead through a per-warp shared-memory ring
//     (TMA bulk copies for 16-byte rows, cp.async otherwise), against b_p
//     and b_n staged once per CTA in shared memory; one pass, no barrier
//     between the products.  The level is split into as many CTAs a block
//     as the card holds at once (solve_split), so the last levels spread
//     over the card.
//   * backsub_cluster_kernel (R <= 8): one launch a level, a thread-block
//     cluster per odd block; each CTA forms its rows of t = b_odd - e x_i
//     - f x_i+1 as rhs_reduce does and stores them into every CTA's shared
//     copy of t by DSMEM, then, after one cluster barrier, its rows of a t
//     (a's rows in flight since the start) and of the interleave.  No
//     device workspace.
//   * rhs_reduce_kernel / backsub_kernel: the tiled products of common.cuh,
//     64 output rows per thread block, for R > 8; backsub there forms t in
//     a workspace in one grid and a t in a second.
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

// ---- the solve: rhs_reduce and backsub ------------------------------------
//
// Both are byte-bound GEMVs over independent K x K blocks at R <= 8.  A warp
// owns one output row at a time, and streams the rows it owns through a
// ring of kSolveStages stages in shared memory, kSolveStages rows ahead,
// each stage one row of every block the row needs (lo and hi; e and f,
// then a) behind an mbarrier: a TMA bulk copy a block row when K % 4 == 0
// and the blocks are 16-byte aligned (VEC = 4), else cp.async pieces of
// VEC = 2 or 1 floats, each lane's arriving on the stage's mbarrier.  The
// bytes in flight are the ring's, not the registers' (holding the rows in
// registers capped a warp at one row pair: 128 registers a thread, one CTA
// an SM, 60% of the byte bound at the P = 64 chain's widest level), and
// each ring waits only for its own rows.  The vectors the rows multiply are
// staged once per CTA in shared memory, transposed (column c of the K x R
// vector at c * ld), so a lane reads the piece of the vector that matches
// its piece of the row, p VEC .. p VEC + VEC - 1 for p = lane, lane + 32,
// ....  A lane sums its pieces in order -- piece, element, the two blocks'
// terms interleaved -- and one butterfly of shuffles per column finishes
// the row.  A level of m2 blocks is split into `split` CTAs a block
// (solve_split), CTA c taking the rows [c n, c n + n), n = ceil(K / split),
// with min(n, kSolveWarpsMax) warps.  A warp starts its first rows' copies
// before the CTA stages the vectors, so the two overlap.
constexpr int kSolveWarpsMax = 16;  // warps a CTA
constexpr int kSolveStages = 2;     // rows a warp has in flight, per ring
constexpr int kSolveMinRows = 8;    // a CTA takes at least this many rows
constexpr int kRhsSplitMax = 32;    // CTAs a block for rhs_reduce
// the mbarriers at the head of a CTA's shared memory: two rings a warp
constexpr int kSolveBarBytes = kSolveWarpsMax * 2 * kSolveStages * 8;

template <int VEC>
__device__ inline void ring_copy(float* dst, const float* src) {
  const uint32_t d = smem_addr(dst);
  if constexpr (VEC == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

template <int VEC>
__device__ inline void smem_piece(float (&dst)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x, dst[1] = t.y;
  } else {
    dst[0] = *p;
  }
}

// One warp's ring: kSolveStages stages of one row of each of NM blocks
// (block m's row at stage + m ld), each behind an mbarrier.
template <int VEC, int NM>
struct Ring {
  float* base;
  uint64_t* bars;
  int ld;

  __device__ float* stage(int st) const { return base + st * NM * ld; }
  // lane 0 sets up the mbarriers: one arrival (the bulk copies' expect_tx)
  // or 32 (every lane's cp.async)
  __device__ void init(int lane) const {
    if (lane == 0) {
      for (int st = 0; st < kSolveStages; ++st) mbar_init(&bars[st], VEC == 4 ? 1 : 32);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  // start copying row j of the blocks into stage st, when j < row1
  __device__ void fetch(int st, const float* const (&blocks)[NM], int j, int row1, int k,
                        int lane) const {
    if (j >= row1) return;
    if constexpr (VEC == 4) {
      if (lane == 0) {
        mbar_expect_tx(&bars[st], NM * k * sizeof(float));
#pragma unroll
        for (int m = 0; m < NM; ++m)
          bulk_copy(stage(st) + m * ld, blocks[m] + (long)j * k, k * sizeof(float), &bars[st]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < NM; ++m)
        for (int s = lane * VEC; s < k; s += 32 * VEC)
          ring_copy<VEC>(stage(st) + m * ld + s, blocks[m] + (long)j * k + s);
      cp_async_arrive(&bars[st]);
    }
  }
  // the use-th row of stage st has landed
  __device__ void wait(int st, int use) const { mbar_wait(&bars[st], use & 1); }
};

// acc[c] = sum_m row_m . v_m[:, c] for the row in a ring stage, summed
// across the warp (every lane gets the sums).
template <int RMAX, int VEC, int NM>
__device__ inline void stage_dot(float (&acc)[RMAX], const float* stage,
                                 const float* const (&v)[NM], int ld, int k, int r, int lane) {
#pragma unroll
  for (int c = 0; c < RMAX; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int s = lane * VEC; s < k; s += 32 * VEC) {
    float x[NM][VEC];
#pragma unroll
    for (int m = 0; m < NM; ++m) smem_piece<VEC>(x[m], stage + m * ld + s);
#pragma unroll
    for (int c = 0; c < RMAX; ++c) {
      if (c >= r) continue;
      float y[NM][VEC];
#pragma unroll
      for (int m = 0; m < NM; ++m) smem_piece<VEC>(y[m], v[m] + c * ld + s);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[c] = fmaf(x[m][e], y[m][e], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < RMAX; ++c) {
    if (c >= r) continue;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  }
}

// dst[c * ld + s] = src[s * r + c] for s < K, c < r: a K x R vector staged
// transposed by the whole CTA.
__device__ inline void stage_vector(float* dst, const float* __restrict__ src, int k, int r,
                                    int ld) {
  for (int e = threadIdx.x; e < k * r; e += blockDim.x) dst[(e % r) * ld + e / r] = src[e];
}

__host__ __device__ inline int solve_ld(int k) { return (k + 3) & ~3; }
__host__ __device__ inline int solve_rows(int k, int split) { return (k + split - 1) / split; }
__host__ __device__ inline int solve_warps(int k, int split) {
  return imin(kSolveWarpsMax, solve_rows(k, split));
}

// out_i = b_2i - lo_i b_max(2i-1,0) - hi_i b_2i+1: grid (m2 * split), CTA
// (i, c) the rows [c n, c n + n) of block i; lo_0 = 0 zeroes the clamped
// neighbour.  Shared: the mbarriers, b_p and b_n transposed (2 RMAX ld
// floats), then each warp's ring (kSolveStages stages of 2 ld floats).
template <int RMAX, int VEC>
__global__ void __launch_bounds__(kSolveWarpsMax * 32)
    rhs_reduce_warp_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                           const float* __restrict__ b, float* __restrict__ out, int k, int r,
                           int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = solve_ld(k), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, i = blockIdx.x / split, n = solve_rows(k, split);
  const int row0 = (blockIdx.x % split) * n, row1 = imin(row0 + n, k);
  const long kk = (long)k * k, kr = (long)k * r;
  const float* const blocks[2] = {lo + i * kk, hi + i * kk};
  const float* b_even = b + 2L * i * kr;
  float* out_i = out + i * kr;
  float* vp = reinterpret_cast<float*>(smem_raw + kSolveBarBytes);
  float* vn = vp + RMAX * ld;
  const Ring<VEC, 2> ring{vn + RMAX * ld + warp * kSolveStages * 2 * ld,
                          reinterpret_cast<uint64_t*>(smem_raw) + warp * kSolveStages, ld};
  const float* const v[2] = {vp, vn};
  ring.init(lane);
#pragma unroll
  for (int st = 0; st < kSolveStages; ++st)
    ring.fetch(st, blocks, row0 + warp + st * nw, row1, k, lane);
  stage_vector(vp, b + (long)max(2 * i - 1, 0) * kr, k, r, ld);
  stage_vector(vn, b + (2L * i + 1) * kr, k, r, ld);
  __syncthreads();
  for (int j = row0 + warp, t = 0; j < row1; j += nw, ++t) {
    const float base = lane < r ? b_even[(long)j * r + lane] : 0.f;
    const int st = t % kSolveStages;
    ring.wait(st, t / kSolveStages);
    float acc[RMAX];
    stage_dot<RMAX, VEC, 2>(acc, ring.stage(st), v, ld, k, r, lane);
#pragma unroll
    for (int c = 0; c < RMAX; ++c)
      if (c < r && lane == c) out_i[(long)j * r + c] = base - acc[c];
    __syncwarp();  // every lane has read the stage
    ring.fetch(st, blocks, j + kSolveStages * nw, row1, k, lane);
  }
}

__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// backsub on a cluster of cs CTAs per odd block i: grid (m2 * cs), cluster
// (cs).  CTA c forms its rows [c n, c n + n) of
//   t_i = b_2i+1 - e_i x_i - f_i x_min(i+1,m2-1)
// (f_{m2-1} = 0 zeroes the clamped neighbour) and stores each row into
// every CTA's copy of t by DSMEM, then, after one cluster barrier, its rows
// of out_2i+1 = a_i t_i from its own copy, and copies its rows of x_i to
// out_2i.  One launch; t never leaves shared memory.  Each warp streams its
// rows of e and f through one ring and of a through a second, whose first
// rows are in flight from the start.  Shared: the mbarriers, x_i, x_next
// and t transposed (3 RMAX ld floats), the e / f rings (kSolveStages stages
// of 2 ld floats a warp) and the a rings (of ld floats).
template <int RMAX, int VEC>
__global__ void __launch_bounds__(kSolveWarpsMax * 32)
    backsub_cluster_kernel(const float* __restrict__ a, const float* __restrict__ e,
                           const float* __restrict__ f, const float* __restrict__ b,
                           const float* __restrict__ x, float* __restrict__ out, int k, int r,
                           int m2) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited on before the first store into a peer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ld = solve_ld(k), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, i = blockIdx.x / cs, n = solve_rows(k, cs);
  const int row0 = rank * n, row1 = imin(row0 + n, k);
  const long kk = (long)k * k, kr = (long)k * r;
  const float* const ef[2] = {e + i * kk, f + i * kk};
  const float* const a_i[1] = {a + i * kk};
  const float* b_odd = b + (2L * i + 1) * kr;
  const float* x_i = x + i * kr;
  float* xv = reinterpret_cast<float*>(smem_raw + kSolveBarBytes);
  float* xn = xv + RMAX * ld;
  float* tv = xn + RMAX * ld;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw) + warp * 2 * kSolveStages;
  const Ring<VEC, 2> ef_ring{tv + RMAX * ld + warp * kSolveStages * 2 * ld, bars, ld};
  const Ring<VEC, 1> a_ring{tv + RMAX * ld + nw * kSolveStages * 2 * ld + warp * kSolveStages * ld,
                            bars + kSolveStages, ld};
  ef_ring.init(lane);
  a_ring.init(lane);
#pragma unroll
  for (int st = 0; st < kSolveStages; ++st)
    ef_ring.fetch(st, ef, row0 + warp + st * nw, row1, k, lane);
#pragma unroll
  for (int st = 0; st < kSolveStages; ++st)
    a_ring.fetch(st, a_i, row0 + warp + st * nw, row1, k, lane);
  stage_vector(xv, x_i, k, r, ld);
  stage_vector(xn, x + (long)min(i + 1, m2 - 1) * kr, k, r, ld);
  float* out_even = out + 2L * i * kr;
  for (long q = (long)row0 * r + threadIdx.x; q < (long)row1 * r; q += blockDim.x)
    out_even[q] = x_i[q];
  __syncthreads();
  cluster_wait();  // every peer is running: its t may be written
  {
    const float* const v[2] = {xv, xn};
    for (int j = row0 + warp, t = 0; j < row1; j += nw, ++t) {
      const float base = lane < r ? b_odd[(long)j * r + lane] : 0.f;
      const int st = t % kSolveStages;
      ef_ring.wait(st, t / kSolveStages);
      float acc[RMAX];
      stage_dot<RMAX, VEC, 2>(acc, ef_ring.stage(st), v, ld, k, r, lane);
#pragma unroll
      for (int c = 0; c < RMAX; ++c)  // t[j, c]: b_odd[j, c] is lane c's base
        if (c < r) acc[c] = __shfl_sync(0xffffffffu, base, c) - acc[c];
      if (lane < cs) {  // lane q writes the row into CTA q's t
        float* peer = cluster.map_shared_rank(tv, lane);
#pragma unroll
        for (int c = 0; c < RMAX; ++c)
          if (c < r) peer[c * ld + j] = acc[c];
      }
      __syncwarp();  // every lane has read the stage
      ef_ring.fetch(st, ef, j + kSolveStages * nw, row1, k, lane);
    }
  }
  cluster.sync();  // every row of t is in every CTA's copy
  const float* const v[1] = {tv};
  float* out_odd = out + (2L * i + 1) * kr;
  for (int j = row0 + warp, t = 0; j < row1; j += nw, ++t) {
    const int st = t % kSolveStages;
    a_ring.wait(st, t / kSolveStages);
    float acc[RMAX];
    stage_dot<RMAX, VEC, 1>(acc, a_ring.stage(st), v, ld, k, r, lane);
#pragma unroll
    for (int c = 0; c < RMAX; ++c)
      if (c < r && lane == c) out_odd[(long)j * r + c] = acc[c];
    __syncwarp();  // every lane has read the stage
    a_ring.fetch(st, a_i, j + kSolveStages * nw, row1, k, lane);
  }
}

// ---- the tiled solve kernels (R > 8, and any R when forced) -------------
// 64 output rows per thread block, the products of common.cuh (block_gemm
// for R > 8); backsub forms t in a device workspace in one grid and a t
// with the interleave in a second, since a t needs all of t.

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

// The SMs of the current device, or a negative cudaError_t code.
int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? sms : -(int)err;
}

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
  const int sms = sm_count();
  return sms < 0 ? sms : reduce_tile_for(m2, k, sms);
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

namespace {

inline int solve_rmax(int r) { return r == 1 ? 1 : r <= 4 ? 4 : 8; }
// Dynamic shared bytes of a CTA of `warps` warps: the mbarriers, the staged
// vectors (2 or 3 of K x RMAX) and the warps' rings (2 or 3 rows of K a
// stage).
inline size_t rhs_smem(int k, int r, int warps) {
  return kSolveBarBytes + sizeof(float) * solve_ld(k) * (2 * solve_rmax(r) + warps * kSolveStages * 2);
}
inline size_t backsub_smem(int k, int r, int warps) {
  return kSolveBarBytes + sizeof(float) * solve_ld(k) * (3 * solve_rmax(r) + warps * kSolveStages * 3);
}
// The warp route takes R <= 8 and a CTA of the widest split (min(K, 16)
// warps) that fits the shared memory a block may opt in to.
bool solve_route_fits(int k, int r, size_t (*smem_of)(int, int, int)) {
  return k >= 1 && r >= 1 && r <= kNarrow &&
         smem_of(k, r, solve_warps(k, 1)) <= (size_t)smem_optin();
}

// The floats a row copy takes: 4 when K % 4 == 0 and the blocks are
// 16-byte aligned, 2 when K is even and they are 8-byte aligned, else 1.
int solve_vec(int k, const float* p1, const float* p2, const float* p3) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(p1) | reinterpret_cast<uintptr_t>(p2) |
                        reinterpret_cast<uintptr_t>(p3);
  if (k % 4 == 0 && (any & 15) == 0) return 4;
  if (k % 2 == 0 && (any & 7) == 0) return 2;
  return 1;
}
inline int aligned_vec(int k) { return k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1; }

// The launch-shape rule of both solve kernels: CTAs a block (rhs_reduce)
// or the cluster size (backsub) for a level of m2 blocks of K rows -- the
// largest power of two, at most `cap`, at which the card holds the whole
// level at once (`fits`: rhs_reduce's m2 * split CTAs within the CTAs an
// SM takes times the SMs, backsub's m2 clusters within the clusters the
// card holds), every CTA keeping at least kSolveMinRows rows: more CTAs
// leave SMs idle less and put more rows in flight, a second wave would
// wait for the first.  tests/test_torch_gpu.py pins its values on an H100.
template <typename Fits>
int solve_split(int k, int cap, Fits fits) {
  int s = 1;
  while (2 * s <= cap && solve_rows(k, 2 * s) >= kSolveMinRows && fits(2 * s)) s *= 2;
  return s;
}

using RhsKernel = void (*)(const float*, const float*, const float*, float*, int, int, int);
using BacksubKernel = void (*)(const float*, const float*, const float*, const float*,
                               const float*, float*, int, int, int);

template <int RMAX>
RhsKernel rhs_kernel_r(int vec) {
  return vec == 4 ? rhs_reduce_warp_kernel<RMAX, 4>
                  : vec == 2 ? rhs_reduce_warp_kernel<RMAX, 2> : rhs_reduce_warp_kernel<RMAX, 1>;
}
RhsKernel rhs_kernel(int r, int vec) {
  const int rm = solve_rmax(r);
  return rm == 1 ? rhs_kernel_r<1>(vec) : rm == 4 ? rhs_kernel_r<4>(vec) : rhs_kernel_r<8>(vec);
}
template <int RMAX>
BacksubKernel backsub_kernel_r(int vec) {
  return vec == 4   ? backsub_cluster_kernel<RMAX, 4>
         : vec == 2 ? backsub_cluster_kernel<RMAX, 2>
                    : backsub_cluster_kernel<RMAX, 1>;
}
BacksubKernel backsub_kernel_for(int r, int vec) {
  const int rm = solve_rmax(r);
  return rm == 1   ? backsub_kernel_r<1>(vec)
         : rm == 4 ? backsub_kernel_r<4>(vec)
                   : backsub_kernel_r<8>(vec);
}

// rhs_reduce's kernel may take the opt-in shared memory (set once per kernel
// and device).
cudaError_t rhs_attributes(RhsKernel kern) {
  static const void* done[9];
  static int done_dev[9], ndone = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int q = 0; q < ndone; ++q)
    if (done[q] == reinterpret_cast<const void*>(kern) && done_dev[q] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (err == cudaSuccess && ndone < 9) {
    done[ndone] = reinterpret_cast<const void*>(kern);
    done_dev[ndone++] = dev;
  }
  return err;
}

// CTAs of rhs_reduce's kernel an SM holds at a split, or a negative code.
int rhs_ctas_per_sm(RhsKernel kern, int k, int r, int split) {
  const cudaError_t err = rhs_attributes(kern);
  if (err != cudaSuccess) return -(int)err;
  const int warps = solve_warps(k, split);
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kern, 32 * warps, rhs_smem(k, r, warps));
  return occ == cudaSuccess ? n : -(int)occ;
}

// The rule's value per (device, kernel, m2, K, R), since its occupancy
// queries are host calls of microseconds and a solve asks at every level.
struct RuleCache {
  struct Entry {
    int dev, kind, m2, k, r, value;
  };
  Entry e[128];
  int used = 0;
  bool find(int dev, int kind, int m2, int k, int r, int* value) const {
    for (int q = 0; q < used; ++q)
      if (e[q].dev == dev && e[q].kind == kind && e[q].m2 == m2 && e[q].k == k && e[q].r == r) {
        *value = e[q].value;
        return true;
      }
    return false;
  }
  void add(int dev, int kind, int m2, int k, int r, int value) {
    if (used < 128) e[used++] = Entry{dev, kind, m2, k, r, value};
  }
};
RuleCache rule_cache;

int rhs_split_for(int m2, int k, int r) {
  if (!solve_route_fits(k, r, rhs_smem)) return 0;
  const int sms = sm_count();
  if (sms < 0) return sms;
  const RhsKernel kern = rhs_kernel(r, aligned_vec(k));
  const int one = rhs_ctas_per_sm(kern, k, r, 1);
  if (one < 0) return one;
  if (one < 1) return -(int)cudaErrorLaunchOutOfResources;
  return solve_split(k, kRhsSplitMax, [&](int s) {
    const int per_sm = rhs_ctas_per_sm(kern, k, r, s);
    return per_sm > 0 && (long)m2 * s <= (long)per_sm * sms;
  });
}

int backsub_cluster_for(int m2, int k, int r) {
  if (!solve_route_fits(k, r, backsub_smem)) return 0;
  const BacksubKernel kern = backsub_kernel_for(r, aligned_vec(k));
  auto active = [&](int cs) {
    const int warps = solve_warps(k, cs);
    return max_active_clusters(kern, cs, backsub_smem(k, r, warps), 32 * warps);
  };
  const int one = active(1);
  if (one < 0) return one;
  if (one < 1) return -(int)cudaErrorLaunchOutOfResources;
  return solve_split(k, kClusterMax, [&](int cs) {
    const int n = active(cs);
    if (n < 0) cudaGetLastError();  // a size the card refuses
    return n >= m2;
  });
}

int cached_rule(int kind, int m2, int k, int r) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int value = 0;
  if (rule_cache.find(dev, kind, m2, k, r, &value)) return value;
  value = kind == 0 ? rhs_split_for(m2, k, r) : backsub_cluster_for(m2, k, r);
  if (value >= 0) rule_cache.add(dev, kind, m2, k, r, value);
  return value;
}

}  // namespace

// CTAs a block of an rhs_reduce level of m2 blocks of K x K with R right-hand
// sides (solve_split, at most kRhsSplitMax); 0 for the tiled kernel (R > 8,
// or rings and vectors too large for shared memory); a negative cudaError_t
// code.
extern "C" int bcr_rhs_reduce_split(int m2, int k, int r) {
  if (m2 <= 0 || k <= 0 || r <= 0) return -(int)cudaErrorInvalidValue;
  return cached_rule(0, m2, k, r);
}

// The cluster size of a backsub level (solve_split, at most kClusterMax);
// 0 for the tiled kernels; a negative cudaError_t code.
extern "C" int bcr_backsub_cluster(int m2, int k, int r) {
  if (m2 <= 0 || k <= 0 || r <= 0) return -(int)cudaErrorInvalidValue;
  return cached_rule(1, m2, k, r);
}

// The clusters of `cluster` CTAs the card holds at once for backsub at
// (K, R) (cudaOccupancyMaxActiveClusters), or a negative cudaError_t code.
extern "C" int bcr_backsub_max_clusters(int k, int r, int cluster) {
  if (k <= 0 || r <= 0 || r > kNarrow || cluster < 1 || cluster > kClusterMax)
    return -(int)cudaErrorInvalidValue;
  const int warps = solve_warps(k, cluster);
  return max_active_clusters(backsub_kernel_for(r, aligned_vec(k)), cluster,
                             backsub_smem(k, r, warps), 32 * warps);
}

// Warps a CTA of either solve kernel runs when a block is split `split` ways.
extern "C" int bcr_solve_warps(int k, int split) {
  return k >= 1 && split >= 1 ? solve_warps(k, split) : -(int)cudaErrorInvalidValue;
}

// The floats of a row copy (4, 2 or 1) for blocks at p1..p3.
extern "C" int bcr_solve_vec(const float* p1, const float* p2, const float* p3, int k) {
  return solve_vec(k, p1, p2, p3);
}

// split: CTAs a block (bcr_rhs_reduce_split's, or (tests) any 1..K); 0
// launches the tiled kernel.  A route that does not fit the shape is an
// error, never a fallback.
extern "C" int bcr_rhs_reduce_launch(const float* lo, const float* hi, const float* b, float* out,
                                     int m2, int k, int r, int split, void* stream) {
  if (m2 <= 0 || k <= 0 || r <= 0 || split < 0 || split > k) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (split == 0) {
    rhs_reduce_kernel<<<dim3(row_tiles(k), m2), kThreads, 0, s>>>(lo, hi, b, out, k, r);
    return (int)cudaGetLastError();
  }
  if (!solve_route_fits(k, r, rhs_smem)) return (int)cudaErrorInvalidValue;
  const RhsKernel kern = rhs_kernel(r, solve_vec(k, lo, hi, hi));
  const cudaError_t err = rhs_attributes(kern);
  if (err != cudaSuccess) return (int)err;
  const int warps = solve_warps(k, split);
  kern<<<m2 * split, 32 * warps, rhs_smem(k, r, warps), s>>>(lo, hi, b, out, k, r, split);
  return (int)cudaGetLastError();
}

// cluster: bcr_backsub_cluster's size, or (tests) any 1..16 the card
// schedules: one launch, t in shared memory (t unused); 0 launches the
// tiled kernels, two grids through the K x R workspace t of each block.
extern "C" int bcr_backsub_launch(const float* a, const float* e, const float* f, const float* b,
                                  const float* x, float* t, float* out, int m2, int k, int r,
                                  int cluster, void* stream) {
  if (m2 <= 0 || k <= 0 || r <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 0) {
    if (t == nullptr) return (int)cudaErrorInvalidValue;
    for (int phase = 0; phase < 2; ++phase) {
      backsub_kernel<<<dim3(row_tiles(k), m2), kThreads, 0, s>>>(a, e, f, b, x, t, out, k, r, m2,
                                                                 phase);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (!solve_route_fits(k, r, backsub_smem)) return (int)cudaErrorInvalidValue;
  const BacksubKernel kern = backsub_kernel_for(r, solve_vec(k, a, e, f));
  const int warps = solve_warps(k, cluster);
  const size_t smem = backsub_smem(k, r, warps);
  const int active = max_active_clusters(kern, cluster, smem, 32 * warps);
  if (active < 0) return -active;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(m2 * cluster), cluster, smem, s, 32 * warps);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, e, f, b, x, out, k, r, m2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
