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
// All arithmetic is FMA in the compute type on the CUDA cores: no tensor
// cores, no TF32.
//
// Storage types (common.cuh): float32, bfloat16 and float64, each with its
// own entry points (bcr_inv_launch, bcr_inv_launch_bf16,
// bcr_inv_launch_f64, and so on); bfloat16 computes in float32, float64 in
// float64.  Every kernel reads its blocks and vectors in the storage type
// and stores its outputs once, rounded to it, as the plain versions round
// each level; what a launch carries to its next launch of the same level
// (reduce's lo and hi, which its second grid reads back; the tiled
// backsub's t) stays in the compute type in a workspace.  In float64 the
// reduce's staged depth is 8 (16 in float32), so the three stages stay
// within the 48 KB of static shared memory; the solve rings copy a block
// row by TMA when it is a multiple of 16 bytes (K % 4 == 0 in float32,
// K % 8 in bfloat16, K % 2 in float64), else element by element.
#include "gj_cluster.cuh"

using namespace sap;

namespace {

constexpr int kRows = 64;  // output rows per block of the narrow kernels

// ---- reduce: staged, register-tiled K x K products -------------------------
//
// A CTA computes one BM x BM output tile of a K x K product
// C = base + sign * (A1 B1 [+ A2 B2]).  The depth (both products' in turn)
// streams in slices of kDepth through kStages shared-memory buffers by
// cp.async, 16 bytes at a time when K % 4 == 0 (an element at a time
// otherwise; storage-type operands other than the compute type by loads
// converted to it), two slices in flight while a third is multiplied, one
// barrier a slice.  Both slices keep the global layout: A's kDepth-wide
// row pieces, so a thread reads four depths of one of its rows as one
// vector, and B's rows.  (Staged transposed, A took 4-byte copies whose
// instructions cost more cycles than the FMAs: tools/kernel_phases.py.)
// Each thread keeps an 8 x TN register tile: rows ty*4..+3 and BM/2 +
// ty*4..+3, columns tx*4..+3 (a vector) and, for TN > 4, the single
// columns 4 kTx + e kTx + tx, so a warp's reads of a slice row are of
// consecutive addresses and every CTA is whole warps (8 x 6 at 96, 8 x 5
// at 80, 8 x 4 at 64 and 32).  Edges past K read zeros and are not stored.
constexpr int kStages = 3;
// the tile sizes a launch may take: 96, 80, 64, 32 (reduce_tile_for)

template <int BM, typename C>
struct TileShape {
  static constexpr int kDepth = sizeof(C) == 8 ? 8 : 16;  // 48 KB of static smem in float64
  static constexpr int TN = BM == 96 ? 6 : BM == 80 ? 5 : 4;
  static constexpr int kTx = BM / TN, kTy = BM / 8, kThreads = kTx * kTy;
  static constexpr int kLdA = kDepth + 4;  // row stride of the A slice
  static constexpr int kStageElems = BM * kLdA + kDepth * BM;
  static_assert(kTx * TN == BM && kThreads % 32 == 0, "a tile is whole warps");
  // column j of thread tx's register tile
  __device__ static int col(int tx, int j) { return j < 4 ? tx * 4 + j : (j * kTx) + tx; }
};

// Stage slice s of the sequence (A1 B1's ns slices, then A2 B2's) into buf.
template <int BM, typename C, typename EA, typename EB>
__device__ inline void stage_tile_slice(C* buf, const EA* A1, const EB* B1, const EA* A2,
                                        const EB* B2, int k, int ns, int s, int r0, int c0,
                                        bool vec) {
  using TS = TileShape<BM, C>;
  constexpr int kDepth = TS::kDepth;
  const EA* A = s < ns ? A1 : A2;
  const EB* B = s < ns ? B1 : B2;
  const int k0 = (s < ns ? s : s - ns) * kDepth;
  C* as = buf;
  C* bs = buf + BM * TS::kLdA;
  if (vec && std::is_same<EA, C>::value) {
    for (int e = threadIdx.x; e < BM * (kDepth / 4); e += TS::kThreads) {
      const int i = e / (kDepth / 4), kk = 4 * (e - i * (kDepth / 4)), row = r0 + i, col = k0 + kk;
      C* dst = as + i * TS::kLdA + kk;
      if (row < k && col < k)
        cp_async_vec4(dst, reinterpret_cast<const C*>(A + (long)row * k + col));
      else
        as4(dst) = v4zero<C>();
    }
  } else {
    for (int e = threadIdx.x; e < BM * kDepth; e += TS::kThreads) {
      const int i = e / kDepth, kk = e - i * kDepth, row = r0 + i, col = k0 + kk;
      C* dst = as + i * TS::kLdA + kk;
      if (row < k && col < k)
        stage_elem(dst, A + (long)row * k + col, true);
      else
        *dst = C(0);
    }
  }
  if (vec && std::is_same<EB, C>::value) {
    for (int e = threadIdx.x; e < kDepth * (BM / 4); e += TS::kThreads) {
      const int kk = e / (BM / 4), j = 4 * (e - kk * (BM / 4)), row = k0 + kk, col = c0 + j;
      C* dst = bs + kk * BM + j;
      if (row < k && col < k)
        cp_async_vec4(dst, reinterpret_cast<const C*>(B + (long)row * k + col));
      else
        as4(dst) = v4zero<C>();
    }
  } else {
    for (int e = threadIdx.x; e < kDepth * BM; e += TS::kThreads) {
      const int kk = e / BM, j = e - kk * BM, row = k0 + kk, col = c0 + j;
      C* dst = bs + kk * BM + j;
      if (row < k && col < k)
        stage_elem(dst, B + (long)row * k + col, true);
      else
        *dst = C(0);
    }
  }
}

// acc = A1 B1 (+ A2 B2 when A2 != nullptr) on the tile at (r0, c0).
template <int BM, typename C, typename EA, typename EB>
__device__ inline void tile_gemm(C* smem, C (&acc)[8][TileShape<BM, C>::TN], const EA* A1,
                                 const EB* B1, const EA* A2, const EB* B2, int k, int r0, int c0,
                                 bool vec) {
  using TS = TileShape<BM, C>;
  constexpr int TN = TS::TN, kDepth = TS::kDepth;
  const int tx = threadIdx.x % TS::kTx, ty = threadIdx.x / TS::kTx;
  const int ns = (k + kDepth - 1) / kDepth, total = A2 ? 2 * ns : ns;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = C(0);
  stage_tile_slice<BM>(smem, A1, B1, A2, B2, k, ns, 0, r0, c0, vec);
  cp_async_commit();
  if (total > 1)
    stage_tile_slice<BM>(smem + TS::kStageElems, A1, B1, A2, B2, k, ns, 1, r0, c0, vec);
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    cp_async_wait<1>();  // staging: slice s has landed
    __syncthreads();     // ... for every thread; slice s-1's buffer is free
    if (s + 2 < total)
      stage_tile_slice<BM>(smem + ((s + 2) % kStages) * TS::kStageElems, A1, B1, A2, B2, k, ns,
                           s + 2, r0, c0, vec);
    cp_async_commit();
    const C* as = smem + (s % kStages) * TS::kStageElems;
    const C* bs = as + BM * TS::kLdA;
#pragma unroll
    for (int k4 = 0; k4 < kDepth; k4 += 4) {
      V4<C> a4[8];  // depths k4..k4+3 of the thread's eight rows
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a4[i] = as4(as + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4) * TS::kLdA + k4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = k4 + u;
        const V4<C> b0 = as4(bs + kk * BM + tx * 4);
        C bv[TN];
        bv[0] = b0.x;
        bv[1] = b0.y;
        bv[2] = b0.z;
        bv[3] = b0.w;
#pragma unroll
        for (int j = 4; j < TN; ++j) bv[j] = bs[kk * BM + TS::col(tx, j)];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const C av = u == 0 ? a4[i].x : u == 1 ? a4[i].y : u == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fma(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // the buffers are free for the caller's next tile_gemm
}

// out = base + sign * acc on the tile at (r0, c0), rounded to T, and the
// unrounded value also to cw when it is not null; base == nullptr means
// zero.
template <int BM, typename T, typename C>
__device__ inline void tile_store(T* out, C* cw, const T* base, C sign,
                                  const C (&acc)[8][TileShape<BM, C>::TN], int k, int r0, int c0,
                                  bool vec) {
  using TS = TileShape<BM, C>;
  const int tx = threadIdx.x % TS::kTx, ty = threadIdx.x / TS::kTx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (row >= k) continue;
    const long at = (long)row * k + c0;
    const int c4 = tx * 4;
    int j0 = 0;
    if constexpr (std::is_same<T, float>::value) {
      if (vec && cw == nullptr) {  // K % 4 == 0: the four columns are all in or all out
        j0 = 4;
        if (c0 + c4 < k) {
          float4 v = base ? *reinterpret_cast<const float4*>(base + at + c4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          v.x += sign * acc[i][0];
          v.y += sign * acc[i][1];
          v.z += sign * acc[i][2];
          v.w += sign * acc[i][3];
          *reinterpret_cast<float4*>(out + at + c4) = v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TS::TN; ++j) {
      if (j < j0) continue;
      const int c = TS::col(tx, j);
      if (c0 + c < k) {
        const C v = (base ? conv<C>(base[at + c]) : C(0)) + sign * acc[i][j];
        out[at + c] = conv<T>(v);
        if (cw != nullptr) cw[at + c] = v;
      }
    }
  }
}

}  // namespace

// dst[i] = inv(src[first + 2 i]) by boosted Gauss-Jordan; grid (count).  W
// in shared memory when it fits, else in dst (storage = compute type) or
// ws (K x K of the compute type a block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    inv_kernel(const T* __restrict__ src, T* dst, Compute<T>* ws, int first, int k,
               Compute<T> boost_eps, int w_in_smem) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* red = reinterpret_cast<C*>(smem_raw);
  C* rowbuf = red + kRed;
  C* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  T* out = dst + blockIdx.x * kk;
  C* W = w_in_smem ? colbuf + k : same ? reinterpret_cast<C*>(out) : ws + blockIdx.x * kk;
  block_copy<C>(rowmajor(W, k), rowmajor(src + (first + 2L * blockIdx.x) * kk, k), k, k);
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  if (w_in_smem || !same) block_copy<C>(rowmajor(out, k), rowmajor(W, k), k, k);
}

// dst[i] = inv(src[first + 2 i]) by boosted Gauss-Jordan on a cluster of
// cs CTAs per block; grid (count * cs), cluster (cs), kClusterThreads
// threads.
//
// Bound: 2 K^3 operations a block (0.1223 ms for the 64 blocks of
// 400 x 400 of the P = 64 interface chain in float32, H100 at 67
// TFLOP/s); inverting one block per thread block left the deep levels,
// which have one or two blocks, on one or two SMs, streaming the block
// through L2 at every column.  Here the block lives in the cluster's
// shared memory, CTA r owning the rows [r R, r R + R), R = ceil(K / cs),
// and is inverted by the blocked Gauss-Jordan of gj_cluster.cuh
// (gj_cluster_inverse), in panels of kPanel columns whose pivot rows
// travel by DSMEM.

// shared bytes of one CTA: the slab and the elimination's scratch
template <typename C>
inline size_t cluster_smem_bytes(int k, int cs) {
  return slab_smem_bytes<C>(k, cs, false);
}

// NC: columns a thread owns in the strip (c = threadIdx.x + n
// kClusterThreads, n < NC)
template <int NC, typename T>
__global__ void __launch_bounds__(kClusterThreads)
    inv_cluster_kernel(const T* __restrict__ src, T* __restrict__ dst, int first, int k,
                       Compute<T> boost_eps) {
  using C = Compute<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab<C> s =
      make_slab(reinterpret_cast<C*>(smem_raw), k, cs, (int)cluster.block_rank(), false);
  const int tid = threadIdx.x, ld = s.ld, row0 = s.row0, nrows = s.nrows;
  C* slab = s.w;
  const long kk = (long)k * k;
  const T* a = src + (first + 2L * (blockIdx.x / cs)) * kk;
  T* out = dst + (long)(blockIdx.x / cs) * kk;

  // this CTA's rows are contiguous in the row-major block: 8 loads in flight a thread
  C mx = C(0);
  const T* mine = a + (long)row0 * k;
  for (int e0 = 0; e0 < nrows * k; e0 += 8 * kClusterThreads) {
    C x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kClusterThreads + tid;
      x[u] = e < nrows * k ? conv<C>(mine[e]) : C(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kClusterThreads + tid;
      if (e < nrows * k) slab[(e / k) * ld + e % k] = x[u];
      mx = fmax(mx, fabs(x[u]));
    }
  }
  const C scale = cluster_max(cluster, mx, s.red);  // slabs and maxima visible to the cluster
  gj_cluster_inverse<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));
  for (int e = tid; e < nrows * k; e += kClusterThreads) {
    const int r = e / k, c = e - r * k;
    out[(long)(row0 + r) * k + c] = conv<T>(slab[r * ld + c]);
  }
}

// phase 0: lo_i = E_2i a_max(i-1,0) (y = 0), hi_i = F_2i a_i (y = 1);
// phase 1: D'_i = D_2i - (lo_i F_p + hi_i E_2i+1) (y = 0), and E'_i =
// -(lo_i E_p) then F'_i = -(hi_i F_2i+1) (y = 1), p = max(2i-1, 0), so every
// CTA of a launch does the same work.  Grid (tiles, 2, m2).  wlo / whi: lo
// and hi in the compute type, which phase 1 reads, when T is not it.
template <int BM, typename T>
__global__ void __launch_bounds__(TileShape<BM, Compute<T>>::kThreads)
    reduce_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ f,
                  const T* __restrict__ a, T* lo, T* hi, T* dn, T* en, T* fn, Compute<T>* wlo,
                  Compute<T>* whi, int k, int phase) {
  using C = Compute<T>;
  using TS = TileShape<BM, C>;
  constexpr bool same = std::is_same<T, C>::value;
  __shared__ __align__(16) C smem[kStages * TS::kStageElems];
  const int i = blockIdx.z, nt = (k + BM - 1) / BM;
  const int r0 = (blockIdx.x / nt) * BM, c0 = (blockIdx.x % nt) * BM;
  const long kk = (long)k * k;
  const bool vec = (k & 3) == 0;
  const T* const no_t = nullptr;
  const C* const no_c = nullptr;
  C acc[8][TS::TN];
  if (phase == 0) {
    const bool is_lo = blockIdx.y == 0;
    tile_gemm<BM>(smem, acc, (is_lo ? e : f) + 2L * i * kk,
                  a + (long)(is_lo ? max(i - 1, 0) : i) * kk, no_t, no_t, k, r0, c0, vec);
    tile_store<BM>((is_lo ? lo : hi) + i * kk, same ? nullptr : (is_lo ? wlo : whi) + i * kk,
                   no_t, C(1), acc, k, r0, c0, vec);
    return;
  }
  const long prv = (long)max(2 * i - 1, 0) * kk, nxt = (2L * i + 1) * kk;
  const C* loi = same ? reinterpret_cast<const C*>(lo + i * kk) : wlo + i * kk;
  const C* hii = same ? reinterpret_cast<const C*>(hi + i * kk) : whi + i * kk;
  if (blockIdx.y == 0) {
    tile_gemm<BM>(smem, acc, loi, f + prv, hii, e + nxt, k, r0, c0, vec);
    tile_store<BM>(dn + i * kk, static_cast<C*>(nullptr), d + 2L * i * kk, C(-1), acc, k, r0, c0,
                   vec);
  } else {
    tile_gemm<BM>(smem, acc, loi, e + prv, no_c, no_t, k, r0, c0, vec);
    tile_store<BM>(en + i * kk, static_cast<C*>(nullptr), no_t, C(-1), acc, k, r0, c0, vec);
    tile_gemm<BM>(smem, acc, hii, f + nxt, no_c, no_t, k, r0, c0, vec);
    tile_store<BM>(fn + i * kk, static_cast<C*>(nullptr), no_t, C(-1), acc, k, r0, c0, vec);
  }
}

// ---- the solve: rhs_reduce and backsub ------------------------------------
//
// Both are byte-bound GEMVs over independent K x K blocks at R <= 8.  A warp
// owns one output row at a time, and streams the rows it owns through a
// ring of kSolveStages stages in shared memory, kSolveStages rows ahead,
// each stage one row of every block the row needs (lo and hi; e and f,
// then a) behind an mbarrier, in the storage type: a TMA bulk copy a block
// row when the row is a multiple of 16 bytes and the blocks are 16-byte
// aligned (VEC = 16 bytes of elements: 4 in float32, 8 in bfloat16, 2 in
// float64), else cp.async pieces of VEC = 2 or 1 float32, or one float64,
// or plain copies of single bfloat16 elements, each lane's arriving on the
// stage's mbarrier.  The bytes in flight are the ring's, not the
// registers' (holding the rows in registers capped a warp at one row
// pair: 128 registers a thread, one CTA an SM, 60% of the byte bound at
// the P = 64 chain's widest level), and each ring waits only for its own
// rows.  The vectors the rows multiply are staged once per CTA in shared
// memory in the compute type, transposed (column c of the K x R vector at
// c * ld), so a lane reads the piece of the vector that matches its piece
// of the row, p VEC .. p VEC + VEC - 1 for p = lane, lane + 32, ....  A
// lane sums its pieces in order -- piece, element, the two blocks' terms
// interleaved -- and one butterfly of shuffles per column finishes the
// row.  A level of m2 blocks is split into `split` CTAs a block
// (solve_split), CTA c taking the rows [c n, c n + n), n = ceil(K /
// split), with min(n, kSolveWarps) warps.  A warp starts its first
// rows' copies before the CTA stages the vectors, so the two overlap.
constexpr int kSolveWarpsMax = 16;  // warps a CTA (8 in float64: kSolveWarps)
constexpr int kSolveStages = 2;     // rows a warp has in flight, per ring
constexpr int kSolveMinRows = 8;    // a CTA takes at least this many rows
constexpr int kRhsSplitMax = 32;    // CTAs a block for rhs_reduce
// the mbarriers at the head of a CTA's shared memory: two rings a warp
constexpr int kSolveBarBytes = kSolveWarpsMax * 2 * kSolveStages * 8;

// elements of the storage type a bulk row copy moves at once (16 bytes)
template <typename T>
constexpr int kBulkVec = 16 / (int)sizeof(T);
// warps a CTA of the solve kernels takes at most: 16, or 8 for float64 so
// that a CTA of the widest split holds its rings at 2K = 400
template <typename T>
constexpr int kSolveWarps = sizeof(T) == 8 ? kSolveWarpsMax / 2 : kSolveWarpsMax;

template <int VEC, typename T>
__device__ inline void ring_copy(T* dst, const T* src) {
  if constexpr (VEC * sizeof(T) == 8)
    cp_async8(dst, src);
  else
    cp_async4(dst, src);
}

// VEC consecutive elements of E in shared memory, in the compute type C
template <int VEC, typename C, typename E>
__device__ inline void smem_piece(C (&dst)[VEC], const E* p) {
  if constexpr (std::is_same<E, float>::value && VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else if constexpr (std::is_same<E, float>::value && VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x, dst[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = conv<C>(p[i]);
  }
}

// One warp's ring: kSolveStages stages of one row of each of NM blocks
// (block m's row at stage + m ld), each behind an mbarrier.
template <int VEC, int NM, typename T>
struct Ring {
  static constexpr bool kBulk = VEC == kBulkVec<T>;
  T* base;
  uint64_t* bars;
  int ld;

  __device__ T* stage(int st) const { return base + st * NM * ld; }
  // lane 0 sets up the mbarriers: one arrival (the bulk copies' expect_tx)
  // or 32 (every lane's copies)
  __device__ void init(int lane) const {
    if (lane == 0) {
      for (int st = 0; st < kSolveStages; ++st) mbar_init(&bars[st], kBulk ? 1 : 32);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  // start copying row j of the blocks into stage st, when j < row1
  __device__ void fetch(int st, const T* const (&blocks)[NM], int j, int row1, int k,
                        int lane) const {
    if (j >= row1) return;
    if constexpr (kBulk) {
      if (lane == 0) {
        mbar_expect_tx(&bars[st], NM * k * sizeof(T));
#pragma unroll
        for (int m = 0; m < NM; ++m)
          bulk_copy(stage(st) + m * ld, blocks[m] + (long)j * k, k * sizeof(T), &bars[st]);
      }
    } else if constexpr (sizeof(T) >= 4) {
#pragma unroll
      for (int m = 0; m < NM; ++m)
        for (int s = lane * VEC; s < k; s += 32 * VEC)
          ring_copy<VEC>(stage(st) + m * ld + s, blocks[m] + (long)j * k + s);
      cp_async_arrive(&bars[st]);
    } else {
#pragma unroll
      for (int m = 0; m < NM; ++m)
        for (int s = lane; s < k; s += 32) stage(st)[m * ld + s] = blocks[m][(long)j * k + s];
      mbar_arrive(&bars[st]);
    }
  }
  // the use-th row of stage st has landed
  __device__ void wait(int st, int use) const { mbar_wait(&bars[st], use & 1); }
};

// acc[c] = sum_m row_m . v_m[:, c] for the row in a ring stage (row m at
// stage + m ldr), v in the compute type (column c at v_m + c ldv), summed
// across the warp (every lane gets the sums).
template <int RMAX, int VEC, int NM, typename C, typename T>
__device__ inline void stage_dot(C (&acc)[RMAX], const T* stage, const C* const (&v)[NM], int ldr,
                                 int ldv, int k, int r, int lane) {
#pragma unroll
  for (int c = 0; c < RMAX; ++c) acc[c] = C(0);
#pragma unroll 4
  for (int s = lane * VEC; s < k; s += 32 * VEC) {
    C x[NM][VEC];
#pragma unroll
    for (int m = 0; m < NM; ++m) smem_piece<VEC>(x[m], stage + m * ldr + s);
#pragma unroll
    for (int c = 0; c < RMAX; ++c) {
      if (c >= r) continue;
      C y[NM][VEC];
#pragma unroll
      for (int m = 0; m < NM; ++m) smem_piece<VEC>(y[m], v[m] + c * ldv + s);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[c] = fma(x[m][e], y[m][e], acc[c]);
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
// transposed by the whole CTA, converted to the compute type.
template <typename C, typename T>
__device__ inline void stage_vector(C* dst, const T* __restrict__ src, int k, int r, int ld) {
  for (int e = threadIdx.x; e < k * r; e += blockDim.x) dst[(e % r) * ld + e / r] = conv<C>(src[e]);
}

__host__ __device__ inline int solve_ld(int k) { return (k + 3) & ~3; }
// a ring row's elements of T: K rounded up to 4 and to 16 bytes
template <typename T>
__host__ __device__ inline int ring_ld(int k) {
  if constexpr (kBulkVec<T> <= 4) return solve_ld(k);
  return (k + kBulkVec<T> - 1) / kBulkVec<T> * kBulkVec<T>;
}
__host__ __device__ inline int solve_rows(int k, int split) { return (k + split - 1) / split; }
template <typename T>
__host__ __device__ inline int solve_warps(int k, int split) {
  return imin(kSolveWarps<T>, solve_rows(k, split));
}

// out_i = b_2i - lo_i b_max(2i-1,0) - hi_i b_2i+1: grid (m2 * split), CTA
// (i, c) the rows [c n, c n + n) of block i; lo_0 = 0 zeroes the clamped
// neighbour.  Shared: the mbarriers, b_p and b_n transposed (2 RMAX ld
// elements of C), then each warp's ring (kSolveStages stages of 2 ring
// rows of T).
template <int RMAX, int VEC, typename T>
__global__ void __launch_bounds__(kSolveWarpsMax * 32)
    rhs_reduce_warp_kernel(const T* __restrict__ lo, const T* __restrict__ hi,
                           const T* __restrict__ b, T* __restrict__ out, int k, int r, int split) {
  using C = Compute<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = solve_ld(k), ldr = ring_ld<T>(k), lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, i = blockIdx.x / split, n = solve_rows(k, split);
  const int row0 = (blockIdx.x % split) * n, row1 = imin(row0 + n, k);
  const long kk = (long)k * k, kr = (long)k * r;
  const T* const blocks[2] = {lo + i * kk, hi + i * kk};
  const T* b_even = b + 2L * i * kr;
  T* out_i = out + i * kr;
  C* vp = reinterpret_cast<C*>(smem_raw + kSolveBarBytes);
  C* vn = vp + RMAX * ld;
  T* rings = reinterpret_cast<T*>(vn + RMAX * ld);
  const Ring<VEC, 2, T> ring{rings + warp * kSolveStages * 2 * ldr,
                             reinterpret_cast<uint64_t*>(smem_raw) + warp * kSolveStages, ldr};
  const C* const v[2] = {vp, vn};
  ring.init(lane);
#pragma unroll
  for (int st = 0; st < kSolveStages; ++st)
    ring.fetch(st, blocks, row0 + warp + st * nw, row1, k, lane);
  stage_vector(vp, b + (long)max(2 * i - 1, 0) * kr, k, r, ld);
  stage_vector(vn, b + (2L * i + 1) * kr, k, r, ld);
  __syncthreads();
  for (int j = row0 + warp, t = 0; j < row1; j += nw, ++t) {
    const C base = lane < r ? conv<C>(b_even[(long)j * r + lane]) : C(0);
    const int st = t % kSolveStages;
    ring.wait(st, t / kSolveStages);
    C acc[RMAX];
    stage_dot<RMAX, VEC, 2>(acc, ring.stage(st), v, ldr, ld, k, r, lane);
#pragma unroll
    for (int c = 0; c < RMAX; ++c)
      if (c < r && lane == c) out_i[(long)j * r + c] = conv<T>(base - acc[c]);
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
// and t transposed (3 RMAX ld elements of C), the e / f rings
// (kSolveStages stages of 2 ring rows of T a warp) and the a rings (of one
// ring row).
template <int RMAX, int VEC, typename T>
__global__ void __launch_bounds__(kSolveWarpsMax * 32)
    backsub_cluster_kernel(const T* __restrict__ a, const T* __restrict__ e,
                           const T* __restrict__ f, const T* __restrict__ b,
                           const T* __restrict__ x, T* __restrict__ out, int k, int r, int m2) {
  using C = Compute<T>;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited on before the first store into a peer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ld = solve_ld(k), ldr = ring_ld<T>(k), lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, i = blockIdx.x / cs, n = solve_rows(k, cs);
  const int row0 = rank * n, row1 = imin(row0 + n, k);
  const long kk = (long)k * k, kr = (long)k * r;
  const T* const ef[2] = {e + i * kk, f + i * kk};
  const T* const a_i[1] = {a + i * kk};
  const T* b_odd = b + (2L * i + 1) * kr;
  const T* x_i = x + i * kr;
  C* xv = reinterpret_cast<C*>(smem_raw + kSolveBarBytes);
  C* xn = xv + RMAX * ld;
  C* tv = xn + RMAX * ld;
  T* rings = reinterpret_cast<T*>(tv + RMAX * ld);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw) + warp * 2 * kSolveStages;
  const Ring<VEC, 2, T> ef_ring{rings + warp * kSolveStages * 2 * ldr, bars, ldr};
  const Ring<VEC, 1, T> a_ring{rings + nw * kSolveStages * 2 * ldr + warp * kSolveStages * ldr,
                               bars + kSolveStages, ldr};
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
  T* out_even = out + 2L * i * kr;
  for (long q = (long)row0 * r + threadIdx.x; q < (long)row1 * r; q += blockDim.x)
    out_even[q] = x_i[q];
  __syncthreads();
  cluster_wait();  // every peer is running: its t may be written
  {
    const C* const v[2] = {xv, xn};
    for (int j = row0 + warp, t = 0; j < row1; j += nw, ++t) {
      const C base = lane < r ? conv<C>(b_odd[(long)j * r + lane]) : C(0);
      const int st = t % kSolveStages;
      ef_ring.wait(st, t / kSolveStages);
      C acc[RMAX];
      stage_dot<RMAX, VEC, 2>(acc, ef_ring.stage(st), v, ldr, ld, k, r, lane);
#pragma unroll
      for (int c = 0; c < RMAX; ++c)  // t[j, c]: b_odd[j, c] is lane c's base
        if (c < r) acc[c] = __shfl_sync(0xffffffffu, base, c) - acc[c];
      if (lane < cs) {  // lane q writes the row into CTA q's t
        C* peer = cluster.map_shared_rank(tv, lane);
#pragma unroll
        for (int c = 0; c < RMAX; ++c)
          if (c < r) peer[c * ld + j] = acc[c];
      }
      __syncwarp();  // every lane has read the stage
      ef_ring.fetch(st, ef, j + kSolveStages * nw, row1, k, lane);
    }
  }
  cluster.sync();  // every row of t is in every CTA's copy
  const C* const v[1] = {tv};
  T* out_odd = out + (2L * i + 1) * kr;
  for (int j = row0 + warp, t = 0; j < row1; j += nw, ++t) {
    const int st = t % kSolveStages;
    a_ring.wait(st, t / kSolveStages);
    C acc[RMAX];
    stage_dot<RMAX, VEC, 1>(acc, a_ring.stage(st), v, ldr, ld, k, r, lane);
#pragma unroll
    for (int c = 0; c < RMAX; ++c)
      if (c < r && lane == c) out_odd[(long)j * r + c] = conv<T>(acc[c]);
    __syncwarp();  // every lane has read the stage
    a_ring.fetch(st, a_i, j + kSolveStages * nw, row1, k, lane);
  }
}

// ---- the tiled solve kernels (R > 8, and any R when forced) -------------
// 64 output rows per thread block, the products of common.cuh (block_gemm
// for R > 8); backsub forms t in a compute-type workspace in one grid and
// a t with the interleave in a second, since a t needs all of t.  Where
// the storage type is not the compute type, the two products of one
// output run in one pass (sub2), so no rounded intermediate is read back.

// out = (base - A1 B1) - A2 B2 for n x r outputs, one thread an element,
// each product's sum in order of the depth as block_gemm takes it.
template <typename Cd, typename EO, typename EA, typename EB, typename EBase>
__device__ void sub2(Mat<EO> out, Mat<EA> A1, Mat<EB> B1, Mat<EA> A2, Mat<EB> B2, Mat<EBase> base,
                     int n, int q, int r) {
  for (int t = threadIdx.x; t < n * r; t += blockDim.x) {
    const int i = t / r, c = t % r;
    Cd s1 = Cd(0), s2 = Cd(0);
    for (int s = 0; s < q; ++s) {
      s1 = fma(A1.template get<Cd>(i, s), B1.template get<Cd>(s, c), s1);
      s2 = fma(A2.template get<Cd>(i, s), B2.template get<Cd>(s, c), s2);
    }
    out.put(i, c, (base.template get<Cd>(i, c) - s1) - s2);
  }
}

// out_i = b_2i - lo_i b_max(2i-1,0) - hi_i b_2i+1 for rows r0..r0+63 of
// block i; grid (row tiles, m2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rhs_reduce_kernel(const T* __restrict__ lo, const T* __restrict__ hi,
                      const T* __restrict__ b, T* out, int k, int r) {
  using C = Compute<T>;
  const int i = blockIdx.y, r0 = blockIdx.x * kRows, n = min(kRows, k - r0);
  const long kk = (long)k * k, kr = (long)k * r;
  const T* bp = b + (long)max(2 * i - 1, 0) * kr;
  const T* bn = b + (2L * i + 1) * kr;
  T* o = out + i * kr + (long)r0 * r;
  if constexpr (std::is_same<T, C>::value) {
    gemm(rowmajor(o, r), rowmajor(lo + i * kk + (long)r0 * k, k), rowmajor(bp, r),
         rowmajor(b + 2L * i * kr + (long)r0 * r, r), C(-1), n, k, r);
    __syncthreads();
    gemm(rowmajor(o, r), rowmajor(hi + i * kk + (long)r0 * k, k), rowmajor(bn, r), rowmajor(o, r),
         C(-1), n, k, r);
  } else {
    sub2<C>(rowmajor(o, r), rowmajor(lo + i * kk + (long)r0 * k, k), rowmajor(bp, r),
            rowmajor(hi + i * kk + (long)r0 * k, k), rowmajor(bn, r),
            rowmajor(b + 2L * i * kr + (long)r0 * r, r), n, k, r);
  }
}

// phase 0: t_i = b_2i+1 - e_i x_i - f_i x_min(i+1,m2-1) (t in the compute
// type); phase 1: out_2i = x_i, out_2i+1 = a_i t_i.  Grid (row tiles, m2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    backsub_kernel(const T* __restrict__ a, const T* __restrict__ e, const T* __restrict__ f,
                   const T* __restrict__ b, const T* __restrict__ x, Compute<T>* t, T* out, int k,
                   int r, int m2, int phase) {
  using C = Compute<T>;
  const int i = blockIdx.y, r0 = blockIdx.x * kRows, n = min(kRows, k - r0);
  const long kk = (long)k * k, kr = (long)k * r, rows = i * kk + (long)r0 * k;
  const long sub = (long)r0 * r;
  C* ti = t + i * kr + sub;
  if (phase == 0) {
    if constexpr (std::is_same<T, C>::value) {
      gemm(rowmajor(ti, r), rowmajor(e + rows, k), rowmajor(x + i * kr, r),
           rowmajor(b + (2L * i + 1) * kr + sub, r), C(-1), n, k, r);
      __syncthreads();
      gemm(rowmajor(ti, r), rowmajor(f + rows, k), rowmajor(x + (long)min(i + 1, m2 - 1) * kr, r),
           rowmajor(ti, r), C(-1), n, k, r);
    } else {
      sub2<C>(rowmajor(ti, r), rowmajor(e + rows, k), rowmajor(x + i * kr, r),
              rowmajor(f + rows, k), rowmajor(x + (long)min(i + 1, m2 - 1) * kr, r),
              rowmajor(b + (2L * i + 1) * kr + sub, r), n, k, r);
    }
  } else {
    gemm(rowmajor(out + (2L * i + 1) * kr + sub, r), rowmajor(a + rows, k),
         rowmajor(t + i * kr, r), none<C>(), C(1), n, k, r);
    block_copy<C>(rowmajor(out + 2L * i * kr + sub, r), rowmajor(x + i * kr + sub, r), n, r);
  }
}

namespace {
inline int row_tiles(int k) { return (k + kRows - 1) / kRows; }
}  // namespace

namespace {

template <typename T>
using InvClusterKernel = void (*)(const T*, T*, int, int, Compute<T>);

// The cluster kernel for K x K blocks on `cluster` CTAs, its launch
// configuration (grid left to the caller) and the clusters the card holds
// at once (cudaOccupancyMaxActiveClusters).  These are host calls of tens
// of microseconds, so each kernel's attributes are set once per device
// (shared memory up to the opt-in maximum, clusters above 8) and the
// occupancy is cached per device, K and cluster size (per storage type:
// the statics are the instantiation's).
template <typename T>
cudaError_t cluster_setup(int k, int cluster, InvClusterKernel<T>* kern, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr, int* active) {
  static int attrs_dev[2] = {-1, -1};
  static int cached_dev[kClusterMax + 1], cached_k[kClusterMax + 1] = {},
      cached_active[kClusterMax + 1];
  const int nc = k > kClusterThreads ? 2 : 1;
  *kern = nc == 1 ? inv_cluster_kernel<1, T> : inv_cluster_kernel<2, T>;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = cluster_smem_bytes<Compute<T>>(k, cluster);
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

// Elements of the compute type a one-block inverse needs in device memory
// a block: K x K when W fits no shared memory and the storage type cannot
// hold it.
template <typename T>
long inv_ws_elems(int k, int cluster) {
  if (cluster != 0 || std::is_same<T, Compute<T>>::value) return 0;
  int w_in_smem = 0;
  gj_smem_bytes<Compute<T>>(k, &w_in_smem);
  return w_in_smem ? 0 : (long)k * k;
}

template <typename T>
int inv_launch_t(const T* src, T* dst, Compute<T>* ws, int count, int first, int k,
                 Compute<T> boost_eps, int cluster, void* stream) {
  if (count <= 0 || k <= 0 || cluster < 0 || cluster > kClusterMax ||
      (cluster > 0 && k > 2 * kClusterThreads) || (inv_ws_elems<T>(k, cluster) > 0 && !ws))
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    int w_in_smem = 0;
    const size_t smem = gj_smem_bytes<Compute<T>>(k, &w_in_smem);
    cudaError_t err = cudaFuncSetAttribute(inv_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    inv_kernel<T><<<count, kThreads, smem, (cudaStream_t)stream>>>(src, dst, ws, first, k,
                                                                   boost_eps, w_in_smem);
    return (int)cudaGetLastError();
  }
  InvClusterKernel<T> kern;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err = cluster_setup<T>(k, cluster, &kern, &cfg, &attr, &active);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(count * cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kern, src, dst, first, k, boost_eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int inv_max_clusters_t(int k, int cluster) {
  if (k <= 0 || cluster < 1 || cluster > kClusterMax || k > 2 * kClusterThreads)
    return -(int)cudaErrorInvalidValue;
  InvClusterKernel<T> kern;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  const cudaError_t err = cluster_setup<T>(k, cluster, &kern, &cfg, &attr, &active);
  return err == cudaSuccess ? active : -(int)err;
}

// The cluster size that inverts K x K blocks on the current device: the
// smallest power of two up to kClusterMax whose slab (cluster_smem_bytes)
// fits the shared memory one block may opt in to; 0 when none does, or K
// exceeds the columns a cluster's threads own -- the one-block kernel then
// inverts in device memory.  A negative cudaError_t code on failure.
template <typename T>
int inv_cluster_size_t(int k) {
  if (k <= 0) return -(int)cudaErrorInvalidValue;
  if (k > 2 * kClusterThreads) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  for (int cs = 1; cs <= kClusterMax; cs *= 2)
    if (cluster_smem_bytes<Compute<T>>(k, cs) <= (size_t)optin) return cs;
  return 0;
}

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
// 32 when K <= 32, where a 64-wide tile would be mostly padding.  The same
// rule for every storage type.
int reduce_tile_for(int m2, int k, int sms) {
  if (k <= 32) return 32;
  const int wide[2] = {96, 80};
  for (const int t : wide) {
    const long nt = (k + t - 1) / t;
    if (nt * t * 100 <= 105L * k && 2L * m2 * nt * nt >= 8L * sms) return t;
  }
  return 64;
}

int reduce_tile_t(int m2, int k) {
  if (m2 <= 0 || k <= 0) return -(int)cudaErrorInvalidValue;
  const int sms = sm_count();
  return sms < 0 ? sms : reduce_tile_for(m2, k, sms);
}

template <int BM, typename T>
cudaError_t launch_reduce(const T* d, const T* e, const T* f, const T* a, T* lo, T* hi, T* dn,
                          T* en, T* fn, Compute<T>* ws, int m2, int k, cudaStream_t s) {
  const int nt = (k + BM - 1) / BM;
  const dim3 grid(nt * nt, 2, m2);
  Compute<T>* wlo = ws;
  Compute<T>* whi = ws ? ws + (long)m2 * k * k : nullptr;
  for (int phase = 0; phase < 2; ++phase) {  // D', E', F' read all of lo and hi
    reduce_kernel<BM, T><<<grid, TileShape<BM, Compute<T>>::kThreads, 0, s>>>(
        d, e, f, a, lo, hi, dn, en, fn, wlo, whi, k, phase);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Elements of the compute type reduce needs in device memory: lo and hi
// (2 m2 K^2) when the storage type is not the compute type.
template <typename T>
long reduce_ws_elems(int m2, int k) {
  return std::is_same<T, Compute<T>>::value ? 0 : 2L * m2 * k * k;
}

template <typename T>
int reduce_launch_t(const T* d, const T* e, const T* f, const T* a, T* lo, T* hi, T* dn, T* en,
                    T* fn, Compute<T>* ws, int m2, int k, int tile, void* stream) {
  if (m2 <= 0 || k <= 0 || tile < 0 || (reduce_ws_elems<T>(m2, k) > 0 && !ws))
    return (int)cudaErrorInvalidValue;
  if (tile == 0) {
    tile = reduce_tile_t(m2, k);
    if (tile < 0) return -tile;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 96: return (int)launch_reduce<96>(d, e, f, a, lo, hi, dn, en, fn, ws, m2, k, s);
    case 80: return (int)launch_reduce<80>(d, e, f, a, lo, hi, dn, en, fn, ws, m2, k, s);
    case 64: return (int)launch_reduce<64>(d, e, f, a, lo, hi, dn, en, fn, ws, m2, k, s);
    case 32: return (int)launch_reduce<32>(d, e, f, a, lo, hi, dn, en, fn, ws, m2, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline int solve_rmax(int r) { return r == 1 ? 1 : r <= 4 ? 4 : 8; }
// Dynamic shared bytes of a CTA of `warps` warps: the mbarriers, the staged
// vectors (2 or 3 of K x RMAX, compute type) and the warps' rings (2 or 3
// ring rows of T a stage).
template <typename T>
inline size_t rhs_smem(int k, int r, int warps) {
  return kSolveBarBytes + sizeof(Compute<T>) * solve_ld(k) * 2 * solve_rmax(r) +
         sizeof(T) * ring_ld<T>(k) * warps * kSolveStages * 2;
}
template <typename T>
inline size_t backsub_smem(int k, int r, int warps) {
  return kSolveBarBytes + sizeof(Compute<T>) * solve_ld(k) * 3 * solve_rmax(r) +
         sizeof(T) * ring_ld<T>(k) * warps * kSolveStages * 3;
}
// The warp route takes R <= 8 and a CTA of the widest split (min(K, 16)
// warps) that fits the shared memory a block may opt in to.
template <typename T>
bool solve_route_fits(int k, int r, size_t (*smem_of)(int, int, int)) {
  return k >= 1 && r >= 1 && r <= kNarrow &&
         smem_of(k, r, solve_warps<T>(k, 1)) <= (size_t)smem_optin();
}

// The elements of a row copy: a bulk row (16 bytes of elements: VEC =
// kBulkVec) when the row is a multiple of 16 bytes and the blocks are
// 16-byte aligned; in float32 else 2 when K is even and they are 8-byte
// aligned; else 1.
template <typename T>
int solve_vec(int k, const void* p1, const void* p2, const void* p3) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(p1) | reinterpret_cast<uintptr_t>(p2) |
                        reinterpret_cast<uintptr_t>(p3);
  if (k % kBulkVec<T> == 0 && (any & 15) == 0) return kBulkVec<T>;
  if (sizeof(T) == 4 && k % 2 == 0 && (any & 7) == 0) return 2;
  return 1;
}
template <typename T>
inline int aligned_vec(int k) {
  return k % kBulkVec<T> == 0 ? kBulkVec<T> : sizeof(T) == 4 && k % 2 == 0 ? 2 : 1;
}

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

template <typename T>
using RhsKernel = void (*)(const T*, const T*, const T*, T*, int, int, int);
template <typename T>
using BacksubKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, int, int,
                               int);

// The kernel of a copy width: the bulk width, 2 (float32 only) or 1.
template <int RMAX, typename T>
RhsKernel<T> rhs_kernel_r(int vec) {
  if (vec == kBulkVec<T>) return rhs_reduce_warp_kernel<RMAX, kBulkVec<T>, T>;
  if constexpr (sizeof(T) == 4)
    if (vec == 2) return rhs_reduce_warp_kernel<RMAX, 2, T>;
  return rhs_reduce_warp_kernel<RMAX, 1, T>;
}
template <typename T>
RhsKernel<T> rhs_kernel(int r, int vec) {
  const int rm = solve_rmax(r);
  return rm == 1 ? rhs_kernel_r<1, T>(vec) : rm == 4 ? rhs_kernel_r<4, T>(vec)
                                                     : rhs_kernel_r<8, T>(vec);
}
template <int RMAX, typename T>
BacksubKernel<T> backsub_kernel_r(int vec) {
  if (vec == kBulkVec<T>) return backsub_cluster_kernel<RMAX, kBulkVec<T>, T>;
  if constexpr (sizeof(T) == 4)
    if (vec == 2) return backsub_cluster_kernel<RMAX, 2, T>;
  return backsub_cluster_kernel<RMAX, 1, T>;
}
template <typename T>
BacksubKernel<T> backsub_kernel_for(int r, int vec) {
  const int rm = solve_rmax(r);
  return rm == 1   ? backsub_kernel_r<1, T>(vec)
         : rm == 4 ? backsub_kernel_r<4, T>(vec)
                   : backsub_kernel_r<8, T>(vec);
}

// rhs_reduce's kernel may take the opt-in shared memory (set once per kernel
// and device).
template <typename Kernel>
cudaError_t rhs_attributes(Kernel kern) {
  static const void* done[32];
  static int done_dev[32], ndone = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int q = 0; q < ndone; ++q)
    if (done[q] == reinterpret_cast<const void*>(kern) && done_dev[q] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (err == cudaSuccess && ndone < 32) {
    done[ndone] = reinterpret_cast<const void*>(kern);
    done_dev[ndone++] = dev;
  }
  return err;
}

// CTAs of rhs_reduce's kernel an SM holds at a split, or a negative code.
template <typename T>
int rhs_ctas_per_sm(RhsKernel<T> kern, int k, int r, int split) {
  const cudaError_t err = rhs_attributes(kern);
  if (err != cudaSuccess) return -(int)err;
  const int warps = solve_warps<T>(k, split);
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kern, 32 * warps, rhs_smem<T>(k, r, warps));
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

template <typename T>
int rhs_split_for(int m2, int k, int r) {
  if (!solve_route_fits<T>(k, r, rhs_smem<T>)) return 0;
  const int sms = sm_count();
  if (sms < 0) return sms;
  const RhsKernel<T> kern = rhs_kernel<T>(r, aligned_vec<T>(k));
  const int one = rhs_ctas_per_sm<T>(kern, k, r, 1);
  if (one < 0) return one;
  if (one < 1) return -(int)cudaErrorLaunchOutOfResources;
  return solve_split(k, kRhsSplitMax, [&](int s) {
    const int per_sm = rhs_ctas_per_sm<T>(kern, k, r, s);
    return per_sm > 0 && (long)m2 * s <= (long)per_sm * sms;
  });
}

template <typename T>
int backsub_cluster_for(int m2, int k, int r) {
  if (!solve_route_fits<T>(k, r, backsub_smem<T>)) return 0;
  const BacksubKernel<T> kern = backsub_kernel_for<T>(r, aligned_vec<T>(k));
  auto active = [&](int cs) {
    const int warps = solve_warps<T>(k, cs);
    return max_active_clusters(kern, cs, backsub_smem<T>(k, r, warps), 32 * warps);
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

template <typename T>
int cached_rule(int kind, int m2, int k, int r) {
  static RuleCache rule_cache;  // one a storage type
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int value = 0;
  if (rule_cache.find(dev, kind, m2, k, r, &value)) return value;
  value = kind == 0 ? rhs_split_for<T>(m2, k, r) : backsub_cluster_for<T>(m2, k, r);
  if (value >= 0) rule_cache.add(dev, kind, m2, k, r, value);
  return value;
}

template <typename T>
int backsub_max_clusters_t(int k, int r, int cluster) {
  if (k <= 0 || r <= 0 || r > kNarrow || cluster < 1 || cluster > kClusterMax)
    return -(int)cudaErrorInvalidValue;
  const int warps = solve_warps<T>(k, cluster);
  return max_active_clusters(backsub_kernel_for<T>(r, aligned_vec<T>(k)), cluster,
                             backsub_smem<T>(k, r, warps), 32 * warps);
}

template <typename T>
int rhs_reduce_launch_t(const T* lo, const T* hi, const T* b, T* out, int m2, int k, int r,
                        int split, void* stream) {
  if (m2 <= 0 || k <= 0 || r <= 0 || split < 0 || split > k) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (split == 0) {
    rhs_reduce_kernel<T><<<dim3(row_tiles(k), m2), kThreads, 0, s>>>(lo, hi, b, out, k, r);
    return (int)cudaGetLastError();
  }
  if (!solve_route_fits<T>(k, r, rhs_smem<T>)) return (int)cudaErrorInvalidValue;
  const RhsKernel<T> kern = rhs_kernel<T>(r, solve_vec<T>(k, lo, hi, hi));
  const cudaError_t err = rhs_attributes(kern);
  if (err != cudaSuccess) return (int)err;
  const int warps = solve_warps<T>(k, split);
  kern<<<m2 * split, 32 * warps, rhs_smem<T>(k, r, warps), s>>>(lo, hi, b, out, k, r, split);
  return (int)cudaGetLastError();
}

template <typename T>
int backsub_launch_t(const T* a, const T* e, const T* f, const T* b, const T* x, Compute<T>* t,
                     T* out, int m2, int k, int r, int cluster, void* stream) {
  if (m2 <= 0 || k <= 0 || r <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 0) {
    if (t == nullptr) return (int)cudaErrorInvalidValue;
    for (int phase = 0; phase < 2; ++phase) {
      backsub_kernel<T><<<dim3(row_tiles(k), m2), kThreads, 0, s>>>(a, e, f, b, x, t, out, k, r,
                                                                    m2, phase);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (!solve_route_fits<T>(k, r, backsub_smem<T>)) return (int)cudaErrorInvalidValue;
  const BacksubKernel<T> kern = backsub_kernel_for<T>(r, solve_vec<T>(k, a, e, f));
  const int warps = solve_warps<T>(k, cluster);
  const size_t smem = backsub_smem<T>(k, r, warps);
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

}  // namespace

// The C entry points, one set per storage type (SAP_DTYPE_ENTRIES: NAME for
// float32, NAME_bf16, NAME_f64):
//
// bcr_inv_launch: cluster > 0 runs inv_cluster_kernel on clusters of that
// many CTAs (at most kClusterMax; K <= 2 kClusterThreads); cluster == 0
// inv_kernel, one block per inverted block, with ws of
// bcr_inv_workspace_floats elements of the compute type a block (else
// unused).  A cluster size the card cannot schedule, or a slab that does
// not fit, is an error, never a fallback.
// bcr_inv_max_clusters: the clusters of `cluster` CTAs the card can hold
// at once for K x K blocks, or a negative cudaError_t code.
// bcr_inv_cluster_size: inv_cluster_size_t above.
//
// bcr_reduce_tile: the tile size a reduce level of m2 rows of K x K blocks
// takes on the current device (reduce_tile_for), or a negative code.
// bcr_reduce_launch: tile 0 takes bcr_reduce_tile's choice; (tests) 96,
// 80, 64 or 32 forces it.  Two launches, lo and hi first; ws holds
// bcr_reduce_workspace_floats elements of the compute type (none for
// float32 and float64).
//
// bcr_rhs_reduce_split: CTAs a block of an rhs_reduce level of m2 blocks of
// K x K with R right-hand sides (solve_split, at most kRhsSplitMax); 0 for
// the tiled kernel (R > 8, or rings and vectors too large for shared
// memory); a negative cudaError_t code.
// bcr_backsub_cluster: the cluster size of a backsub level (solve_split,
// at most kClusterMax); 0 for the tiled kernels; a negative code.
// bcr_backsub_max_clusters: the clusters of `cluster` CTAs the card holds
// at once for backsub at (K, R), or a negative code.
// bcr_solve_warps: warps a CTA of either solve kernel runs when a block is
// split `split` ways (at most 16; 8 in float64).
// bcr_solve_vec: the elements of a row copy for blocks at p1..p3.
// bcr_rhs_reduce_launch: split is CTAs a block (bcr_rhs_reduce_split's, or
// (tests) any 1..K); 0 launches the tiled kernel.  A route that does not
// fit the shape is an error, never a fallback.
// bcr_backsub_launch: cluster is bcr_backsub_cluster's size, or (tests) any
// 1..16 the card schedules: one launch, t in shared memory (t unused); 0
// launches the tiled kernels, two grids through the K x R workspace t of
// each block, in the compute type.
#define BCR_ENTRIES(T, SUF, C)                                                                  \
  extern "C" int bcr_inv_launch##SUF(const T* src, T* dst, C* ws, int count, int first, int k,  \
                                     C boost_eps, int cluster, void* stream) {                  \
    return inv_launch_t<T>(src, dst, ws, count, first, k, boost_eps, cluster, stream);          \
  }                                                                                             \
  extern "C" long bcr_inv_workspace_floats##SUF(int k, int cluster) {                           \
    return inv_ws_elems<T>(k, cluster);                                                         \
  }                                                                                             \
  extern "C" int bcr_inv_max_clusters##SUF(int k, int cluster) {                                \
    return inv_max_clusters_t<T>(k, cluster);                                                   \
  }                                                                                             \
  extern "C" int bcr_inv_cluster_size##SUF(int k) { return inv_cluster_size_t<T>(k); }          \
  extern "C" int bcr_reduce_tile##SUF(int m2, int k) { return reduce_tile_t(m2, k); }           \
  extern "C" long bcr_reduce_workspace_floats##SUF(int m2, int k) {                             \
    return reduce_ws_elems<T>(m2, k);                                                           \
  }                                                                                             \
  extern "C" int bcr_reduce_launch##SUF(const T* d, const T* e, const T* f, const T* a, T* lo,  \
                                        T* hi, T* dn, T* en, T* fn, C* ws, int m2, int k,       \
                                        int tile, void* stream) {                               \
    return reduce_launch_t<T>(d, e, f, a, lo, hi, dn, en, fn, ws, m2, k, tile, stream);         \
  }                                                                                             \
  extern "C" int bcr_rhs_reduce_split##SUF(int m2, int k, int r) {                              \
    if (m2 <= 0 || k <= 0 || r <= 0) return -(int)cudaErrorInvalidValue;                       \
    return cached_rule<T>(0, m2, k, r);                                                         \
  }                                                                                             \
  extern "C" int bcr_backsub_cluster##SUF(int m2, int k, int r) {                               \
    if (m2 <= 0 || k <= 0 || r <= 0) return -(int)cudaErrorInvalidValue;                       \
    return cached_rule<T>(1, m2, k, r);                                                         \
  }                                                                                             \
  extern "C" int bcr_backsub_max_clusters##SUF(int k, int r, int cluster) {                     \
    return backsub_max_clusters_t<T>(k, r, cluster);                                            \
  }                                                                                             \
  extern "C" int bcr_solve_warps##SUF(int k, int split) {                                       \
    return k >= 1 && split >= 1 ? solve_warps<T>(k, split) : -(int)cudaErrorInvalidValue;         \
  }                                                                                             \
  extern "C" int bcr_solve_vec##SUF(const T* p1, const T* p2, const T* p3, int k) {             \
    return solve_vec<T>(k, p1, p2, p3);                                                         \
  }                                                                                             \
  extern "C" int bcr_rhs_reduce_launch##SUF(const T* lo, const T* hi, const T* b, T* out,       \
                                            int m2, int k, int r, int split, void* stream) {    \
    return rhs_reduce_launch_t<T>(lo, hi, b, out, m2, k, r, split, stream);                     \
  }                                                                                             \
  extern "C" int bcr_backsub_launch##SUF(const T* a, const T* e, const T* f, const T* b,        \
                                         const T* x, C* t, T* out, int m2, int k, int r,        \
                                         int cluster, void* stream) {                           \
    return backsub_launch_t<T>(a, e, f, b, x, t, out, m2, k, r, cluster, stream);               \
  }
SAP_DTYPE_ENTRIES(BCR_ENTRIES)
