// A K x K block held row-wise across a thread-block cluster: the boosted
// panel Gauss-Jordan inverse on it, and the K x K products of the block
// recurrences by owned rows.  Shared by bcr.cu (inv_cluster_kernel),
// btf.cu and fused_spike.cu.
//
// Layout.  A cluster of cs CTAs owns one block; CTA r owns the rows
// [r R, r R + R), R = ceil(K / cs), in a slab of R x ld elements of the
// compute type C (common.cuh: float for float32 and bfloat16 storage,
// double for float64) in its shared memory (ld = K rounded up to 4; the
// pad columns are zero).  A float64 slab is twice the bytes, so the same
// block takes a larger cluster.  Beside the
// slab each CTA keeps a scratch area that the elimination uses for the
// strip of pivot rows and the products use to stage their operands, two
// pivot columns and the reduction scratch.
//
// The elimination is blocked Gauss-Jordan in panels of kPanel columns, in
// the in-place form of gj_inverse_inplace (common.cuh): for the panel
// P = [t0, t0 + b),
//   (i)   every CTA copies the b pivot rows (the strip) from their owners'
//         shared memory into its own, then into registers, thread c
//         holding column c;
//   (ii)  every CTA runs the b sequential steps of the unblocked
//         algorithm on its copy of the strip -- the pivot, its boost, the
//         structural-zero test of W[t, t..K-1] and the updates, exactly as
//         gj_inverse_inplace does them -- one barrier a step; the result,
//         the processed strip R, goes to shared memory;
//   (iii) every CTA updates each of its non-panel rows i as
//         row_i <- (row_i, the P columns zeroed) - row_i[P] R,
//         a rank-b product, 4 x 4 register tiles of (rows, columns);
//   (iv)  cluster barrier: every strip has been read and every row updated,
//         so the owners write R into their panel rows (at the start of the
//         next panel) and the next strip can be read.
// The composite of the panel's b steps on a row outside P is that rank-b
// update, so this is the column-by-column algorithm up to the order of
// each element's sum.  scale = max |A| is a cluster-wide maximum taken
// before the first panel (cluster_max); a structurally zero row stays zero
// under (iii), as under the unblocked steps.  FMA in C on the CUDA cores:
// no tensor cores, no TF32.  The products read their device operands in
// the storage type T or in C (the carried workspaces) and convert on load.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace sap {

namespace cg = cooperative_groups;

constexpr int kPanel = 32;
constexpr int kClusterMax = 16;
constexpr int kClusterThreads = 512;
constexpr int kTileRows = 8;  // a product thread's register tile: 8 rows x 4 columns
constexpr int kStage = 16;    // depth of a product's staged slice; two slices in flight

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int slab_rows(int k, int cs) { return (k + cs - 1) / cs; }
__host__ __device__ inline int slab_ld(int k) { return (k + 3) & ~3; }

// Rows of A one product pass stages: the row tiles that kClusterThreads
// consecutive tiles of a row-major tile order touch, at most the slab's.
__host__ __device__ inline int pass_rows(int k, int cs) {
  const int n4 = slab_ld(k) / 4, tiles = (slab_rows(k, cs) + kTileRows - 1) / kTileRows;
  return kTileRows * imin(tiles, (kClusterThreads - 1) / n4 + 2);
}

// Elements of a CTA's scratch: the elimination's strip and panel columns,
// and, when `products`, at least the products' staged operands.
__host__ __device__ inline int slab_scratch_elems(int k, int cs, bool products) {
  const int ld = slab_ld(k), rows4 = (slab_rows(k, cs) + 3) & ~3;
  const int gj = kPanel * rows4 + kPanel * ld;
  const int prod = 2 * kStage * (pass_rows(k, cs) + 4 + ld);  // two staged slices
  return products ? imax(gj, prod) : gj;
}

// Dynamic shared bytes of one CTA: slab, scratch, pivot columns, reduction,
// all of the compute type C.
template <typename C>
inline size_t slab_smem_bytes(int k, int cs, bool products) {
  return sizeof(C) * ((size_t)slab_rows(k, cs) * slab_ld(k) +
                      slab_scratch_elems(k, cs, products) + 2 * kPanel + kRed);
}

// One CTA's view of the block.
template <typename C>
struct Slab {
  C* w;       // rows x ld: W[row0 + r, c] at r * ld + c
  C* rowp;    // kPanel x rows4: W[row0 + r, t0 + j] at j * rows4 + r  (elimination)
  C* strip;   // kPanel x ld: the strip as copied, then R              (elimination)
  C* stage;   // the products' staged operands (the same scratch)
  C* colbuf;  // 2 x kPanel: the strip's pivot column, by step parity
  C* red;     // kRed
  int k, cs, rows, ld, rows4, row0, nrows;
};

template <typename C>
__device__ inline Slab<C> make_slab(C* smem, int k, int cs, int rank, bool products) {
  Slab<C> s;
  s.k = k;
  s.cs = cs;
  s.rows = slab_rows(k, cs);
  s.ld = slab_ld(k);
  s.rows4 = (s.rows + 3) & ~3;
  s.row0 = rank * s.rows;
  s.nrows = max(0, min(s.rows, k - s.row0));
  s.w = smem;
  s.rowp = s.w + s.rows * s.ld;
  s.strip = s.rowp + kPanel * s.rows4;
  s.stage = s.rowp;
  s.colbuf = s.rowp + slab_scratch_elems(k, cs, products);
  s.red = s.colbuf + 2 * kPanel;
  return s;
}

// The cluster-wide maximum of every thread's `mx`: the CTA's maximum into
// red[32], a cluster barrier (which also publishes every slab written
// before it), then the maximum over the CTAs' red[32].  The next write of
// red[32] comes after a later cluster barrier (the panels'), so no CTA
// reads it while it changes.
template <typename C>
__device__ inline C cluster_max(cg::cluster_group& cluster, C mx, C* red) {
  block_max(mx, red);
  cluster.sync();
  C scale = C(0);
  const int cs = (int)cluster.num_blocks();
  for (int r = 0; r < cs; ++r) scale = fmax(scale, cluster.map_shared_rank(red, r)[32]);
  return scale;
}

// In-place inverse of the block in the cluster's slabs by boosted panel
// Gauss-Jordan, pivots below thr = boost_eps * scale boosted (scale from
// cluster_max, which also made the slabs visible).  On return each CTA's
// slab holds its rows of the inverse; its peers may still be in the last
// panel's update, so a CTA that reads another's slab next syncs the
// cluster first.  NC: columns a thread owns in the strip (c = threadIdx.x +
// n kClusterThreads, n < NC); K <= NC kClusterThreads.  Inlined into its
// caller (inv_cluster_kernel); kernels that also run products call
// gj_cluster_inverse_apart.
template <int NC, typename C>
__device__ __forceinline__ void gj_cluster_inverse(cg::cluster_group& cluster, const Slab<C>& s,
                                                   C thr) {
  const int tid = threadIdx.x, k = s.k, ld = s.ld, rows = s.rows, rows4 = s.rows4;
  const int row0 = s.row0, nrows = s.nrows;
  C* slab = s.w;
  C* rowp = s.rowp;
  C* strip = s.strip;
  C* colbuf = s.colbuf;

  // this CTA's rows of the panel at p0 (b0 rows) take R from `strip`
  auto take_r = [&](int p0, int b0) {
    const int lo = max(p0, row0), hi = min(p0 + b0, row0 + nrows), n4 = ld / 4;
    for (int e = tid; e < (hi - lo) * n4; e += kClusterThreads) {
      const int row = lo + e / n4, c4 = e % n4;
      as4(slab + (row - row0) * ld + 4 * c4) = as4(strip + (row - p0) * ld + 4 * c4);
    }
  };

  int prev = 0, prev_b = 0;  // the previous panel, whose R is in `strip`
  for (int t0 = 0; t0 < k; t0 += kPanel) {
    const int b = min(kPanel, k - t0);
    take_r(prev, prev_b);  // (iv) of the previous panel
    __syncthreads();        // `strip` has been read
    // (i) the strip, from its owners: 16-byte (or wider) copies into
    // `strip` (remote shared memory serves few requests a cycle, so 4-byte
    // reads are slow), then each thread takes its columns
    const int n4 = ld / 4;
    for (int e = tid; e < b * n4; e += kClusterThreads) {
      const int j = e / n4, row = t0 + j, owner = row / rows;
      as4(strip + j * ld + 4 * (e - j * n4)) = as4(
          cluster.map_shared_rank(slab, owner) + (row - owner * rows) * ld + 4 * (e - j * n4));
    }
    __syncthreads();
    C sv[NC][kPanel];  // sv[n][j] = W[t0 + j, c_n]
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = tid + n * kClusterThreads;
        sv[n][j] = j < b && c < k ? strip[j * ld + c] : C(0);
      }
    // (ii) the b steps on the strip
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      if (j < b) {
        const int t = t0 + j;
        C* cb = colbuf + (j & 1) * kPanel;
        bool nz = false;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = tid + n * kClusterThreads;
          if (c == t) {
#pragma unroll
            for (int i4 = 0; i4 < kPanel / 4; ++i4)
              as4(cb + 4 * i4) =
                  v4(sv[n][4 * i4], sv[n][4 * i4 + 1], sv[n][4 * i4 + 2], sv[n][4 * i4 + 3]);
          }
          nz |= c >= t && c < k && sv[n][j] != C(0);
        }
        nz = __syncthreads_or(nz);  // W[t, t..K-1] has a nonzero; cb is written
        C piv = cb[j];
        if (fabs(piv) < thr) piv = piv >= C(0) ? thr : -thr;
        if (!nz) piv = C(1);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          // row t / piv, column t of the I half 1 / piv; the other rows
          // subtract cb[i] times it, column t (own) starting from 0
          if (tid + n * kClusterThreads >= k) continue;  // whole warps past K skip the work
          const bool own = tid + n * kClusterThreads == t;
          const C rv = (own ? C(1) : sv[n][j]) / piv;
          if (own) {
#pragma unroll
            for (int i = 0; i < kPanel; ++i) sv[n][i] = C(0);
          }
#pragma unroll
          for (int i4 = 0; i4 < kPanel / 4; ++i4) {
            const V4<C> c4 = as4(cb + 4 * i4);
            const C ci[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * i4 + e != j) sv[n][4 * i4 + e] = fma(-ci[e], rv, sv[n][4 * i4 + e]);
          }
          sv[n][j] = rv;
        }
      }
    }
    // R and this CTA's rows' panel columns to shared memory
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tid + n * kClusterThreads;
      if (c < ld) {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) strip[j * ld + c] = sv[n][j];
      }
    }
    for (int e = tid; e < kPanel * nrows; e += kClusterThreads) {
      const int j = e / nrows, r = e - j * nrows;
      rowp[j * rows4 + r] = j < b ? slab[r * ld + t0 + j] : C(0);
    }
    __syncthreads();
    // (iii) tiles of 4 rows x 4 columns; panel rows are computed, not stored
    const int ntiles = ((nrows + 3) / 4) * n4;
    for (int e = tid; e < ntiles; e += kClusterThreads) {
      const int r0 = 4 * (e / n4), c0 = 4 * (e % n4);
      C acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const V4<C> w = r0 + i < nrows ? as4(slab + (r0 + i) * ld + c0) : v4zero<C>();
        const C wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = c0 + q >= t0 && c0 + q < t0 + b ? C(0) : wv[q];
      }
#pragma unroll 8
      for (int j = 0; j < kPanel; ++j) {
        const V4<C> pa = as4(rowp + j * rows4 + r0);
        const V4<C> rb = as4(strip + j * ld + c0);
        const C pv[4] = {pa.x, pa.y, pa.z, pa.w}, rv[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fma(-pv[i], rv[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + r0 + i;
        if (r0 + i < nrows && (row < t0 || row >= t0 + b))
          as4(slab + (r0 + i) * ld + c0) = v4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    cluster.sync();  // (iv)
    prev = t0;
    prev_b = b;
  }
  take_r(prev, prev_b);  // the last panel's rows
  __syncthreads();
}

// gj_cluster_inverse compiled apart from its caller, for btf's and the
// fused pass's kernels: inlined there beside the products, it spilled.
template <int NC, typename C>
__device__ __noinline__ void gj_cluster_inverse_apart(cg::cluster_group& cluster, const Slab<C>& s,
                                                      C thr) {
  gj_cluster_inverse<NC>(cluster, s, thr);
}

// mbarriers, TMA bulk copies and cp.async arrivals (bts.cu, bcr.cu's
// solve rings)
__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// the transfer's byte count, then the copy that completes it
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// a plain arrival (release: this thread's earlier shared stores are seen by
// the waiters)
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 4, 8 and 16 bytes global -> shared, asynchronously (cp.async)
__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ inline void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// one element of C (4 or 8 bytes) global -> shared, asynchronously
template <typename C>
__device__ inline void cp_async_elem(C* dst, const C* src) {
  if constexpr (sizeof(C) == 8)
    cp_async8(dst, src);
  else
    cp_async4(dst, src);
}
// four consecutive elements of C (16 or 32 bytes, 16-byte aligned)
template <typename C>
__device__ inline void cp_async_vec4(C* dst, const C* src) {
  cp_async16(dst, src);
  if constexpr (sizeof(C) == 8) cp_async16(dst + 2, src + 2);
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst = src: by cp.async when the source already holds the compute type
// C and lies in device memory, else a load converted to C.
template <typename C, typename E>
__device__ inline void stage_elem(C* dst, const E* src, bool global) {
  if constexpr (std::is_same<E, C>::value) {
    if (global)
      cp_async_elem(dst, src);
    else
      *dst = *src;
  } else {
    *dst = conv<C>(*src);
  }
}

// Start staging the slice [k0, k0 + kStage) of the product's operands: the
// pass's rows [rbase, rbase + arows) of A transposed into `as` (stride
// astride), B's rows into `bs` (stride ld); zeros past the edges.  Device
// operands of the compute type are copied by cp.async (16 bytes at a time
// for B when its rows are contiguous and aligned); storage-type operands
// and A in shared memory by loads converted to C.
template <typename C, typename EA, typename EB>
__device__ inline void stage_slice(const Slab<C>& s, Mat<EA> A, bool a_global, Mat<EB> B,
                                   bool b_vec, C* as, C* bs, int astride, int rbase, int arows,
                                   int n, int q, int r, int k0) {
  const int tid = threadIdx.x, ld = s.ld, n4 = ld / 4;
  for (int e = tid; e < arows * kStage; e += kClusterThreads) {
    const int i = e / kStage, kk = e - i * kStage, row = rbase + i, col = k0 + kk;
    C* dst = as + kk * astride + i;
    if (row < n && col < q)
      stage_elem(dst, &A.at(row, col), a_global);
    else
      *dst = C(0);
  }
  if (b_vec) {
    for (int e = tid; e < kStage * n4; e += kClusterThreads) {
      const int kk = e / n4, c = 4 * (e - kk * n4), row = k0 + kk;
      C* dst = bs + kk * ld + c;
      if constexpr (std::is_same<EB, C>::value) {
        if (row < q && c < r)
          cp_async_vec4(dst, &B.at(row, c));
        else
          as4(dst) = v4zero<C>();
      }
    }
  } else {
    for (int e = tid; e < kStage * ld; e += kClusterThreads) {
      const int kk = e / ld, c = e - kk * ld, row = k0 + kk;
      C* dst = bs + kk * ld + c;
      if (row < q && c < r)
        stage_elem(dst, &B.at(row, c), true);
      else
        *dst = C(0);
    }
  }
}

// C = base + sign * (A @ B) for this CTA's n rows of A (n x q) and C (n x r),
// r <= ld; base.p == nullptr means zero; sign is +1 or -1, so "base - A@B"
// and "-(A@B)" round as the plain versions' expressions do, up to the order
// of the inner sum.  The output is cut into tiles of kTileRows x 4 in
// row-major tile order; each pass gives one tile to each thread, which
// keeps it in registers over the whole depth, and streams the depth in
// slices of kStage through two buffers in the slab's scratch (the next
// slice's copies in flight while this one is multiplied): the pass's rows
// of A, transposed, and the slice of B, so a warp reads one row of B with
// consecutive 16-byte loads and broadcasts A.  Compiled apart from its
// caller, which keeps it clear of the caller's live registers (inlined, it
// spilled).  The operands may each be of the storage or the compute type
// (converted as staged); the output is stored as its own type.  C must not
// overlap A, B or the scratch.  Returns the thread's max |C| over the
// entries it wrote, before the output's rounding.
template <typename Cd, typename EO, typename EA, typename EB, typename EBase>
__device__ __noinline__ Cd slab_product(const Slab<Cd>& s, Mat<EO> C, Mat<EA> A, Mat<EB> B,
                                        Mat<EBase> base, Cd sign, int n, int q, int r) {
  const int tid = threadIdx.x, ld = s.ld, n4 = ld / 4;
  const int nrt = (n + kTileRows - 1) / kTileRows, ntiles = nrt * n4;
  const int astride = pass_rows(s.k, s.cs) + 4, nslices = (q + kStage - 1) / kStage;
  Cd* as[2] = {s.stage, s.stage + kStage * (astride + ld)};
  Cd* bs[2] = {as[0] + kStage * astride, as[1] + kStage * astride};
  const bool a_global = __isGlobal(A.p);
  const bool b_vec = std::is_same<EB, Cd>::value && B.cs == 1 && B.rs % 4 == 0 && r % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(B.p) & 15) == 0 && __isGlobal(B.p);
  Cd mx = Cd(0);
  for (int t0 = 0; t0 < ntiles; t0 += kClusterThreads) {
    const int rt_lo = t0 / n4, rt_hi = min((t0 + kClusterThreads - 1) / n4, nrt - 1);
    const int rbase = kTileRows * rt_lo, arows = kTileRows * (rt_hi - rt_lo + 1);
    const int tile = t0 + tid;
    const int rt = tile / n4, ct = tile % n4;
    const int ar = kTileRows * (rt - rt_lo), c0 = 4 * ct;
    Cd acc[kTileRows][4];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = Cd(0);
    stage_slice(s, A, a_global, B, b_vec, as[0], bs[0], astride, rbase, arows, n, q, r, 0);
    cp_async_commit();
    for (int sl = 0; sl < nslices; ++sl) {
      if (sl + 1 < nslices) {
        const int nb = (sl + 1) & 1;
        stage_slice(s, A, a_global, B, b_vec, as[nb], bs[nb], astride, rbase, arows, n, q, r,
                    (sl + 1) * kStage);
        cp_async_commit();
        cp_async_wait<1>();  // slice sl has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (tile < ntiles) {
        const Cd* a = as[sl & 1] + ar;
        const Cd* b = bs[sl & 1] + c0;
#pragma unroll
        for (int kk = 0; kk < kStage; ++kk) {
          const V4<Cd> a0 = as4(a + kk * astride);
          const V4<Cd> a1 = as4(a + kk * astride + 4);
          const V4<Cd> bv = as4(b + kk * ld);
          const Cd av[kTileRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const Cd bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < kTileRows; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bb[j], acc[i][j]);
        }
      }
      __syncthreads();  // this buffer is free for slice sl + 2
    }
    if (tile < ntiles) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const int row = kTileRows * rt + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (row < n && c0 + j < r) {
            const Cd v = (base.p ? base.template get<Cd>(row, c0 + j) : Cd(0)) + sign * acc[i][j];
            C.put(row, c0 + j, v);
            mx = fmax(mx, fabs(v));
          }
        }
      }
    }
  }
  return mx;
}

// Copy rows [0, n) of an n x r matrix into the slab (pad columns zeroed),
// converted to C, and return the thread's max |value|.
template <typename C, typename E>
__device__ inline C slab_load(const Slab<C>& s, Mat<E> src, int n) {
  C mx = C(0);
  for (int e = threadIdx.x; e < n * s.ld; e += blockDim.x) {
    const int r = e / s.ld, c = e - r * s.ld;
    const C v = c < s.k ? src.template get<C>(r, c) : C(0);
    s.w[e] = v;
    mx = fmax(mx, fabs(v));
  }
  return mx;
}

// dst rows [0, n) = this CTA's slab rows, rounded to dst's type.
template <typename C, typename E>
__device__ inline void slab_store(const Slab<C>& s, Mat<E> dst, int n) {
  for (int e = threadIdx.x; e < n * s.k; e += blockDim.x) {
    const int r = e / s.k, c = e - r * s.k;
    dst.put(r, c, s.w[r * s.ld + c]);
  }
}

// dst = src for this CTA's n rows of K (the carried value in C to its
// output, rounded), when the two are different buffers.
template <typename C, typename E>
__device__ inline void rows_out(E* dst, const C* src, long n_elems) {
  if (static_cast<const void*>(dst) == static_cast<const void*>(src)) return;
  for (long e = threadIdx.x; e < n_elems; e += blockDim.x) dst[e] = conv<E>(src[e]);
}

// Host side of a cluster launch: attributes set once per kernel and
// device (shared memory up to the opt-in maximum, clusters above 8), and
// the clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// cached per kernel, cluster size and shared bytes, since these are host
// calls of tens of microseconds.

inline int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

inline void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid, int cs,
                           size_t smem, cudaStream_t stream, int threads = kClusterThreads) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The clusters of cs CTAs of `threads` threads with `smem` bytes each that
// the card holds at once for `kern`, or a negative cudaError_t code.
template <typename Kernel>
int max_active_clusters(Kernel kern, int cs, size_t smem, int threads = kClusterThreads) {
  struct Entry {
    const void* kern;
    int dev, cs;
    size_t smem;
    int threads, active;
  };
  static Entry cache[64];
  static int used = 0;
  static const void* attrs_set[24];
  static int attrs_dev[24], nattrs = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  const void* key = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == key && cache[i].dev == dev && cache[i].cs == cs &&
        cache[i].smem == smem && cache[i].threads == threads)
      return cache[i].active;
  bool set = false;
  for (int i = 0; i < nattrs; ++i) set |= attrs_set[i] == key && attrs_dev[i] == dev;
  if (!set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    if (nattrs < 24) {
      attrs_set[nattrs] = key;
      attrs_dev[nattrs++] = dev;
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(cs), cs, smem, 0, threads);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (used < 64) cache[used++] = Entry{key, dev, cs, smem, threads, active};
  return active;
}

// Starting from cs (a size whose smem_of(cs) bytes fit), the cluster size
// doubled while the chains' clusters of the doubled size still fit on the
// card at once, up to kClusterMax.  A negative cudaError_t code on failure.
template <typename Kernel, typename SmemOf>
int grow_cluster(Kernel kern, int chains, int cs, SmemOf smem_of) {
  const int active = max_active_clusters(kern, cs, smem_of(cs));
  if (active < 0) return active;
  if (active < 1) return -(int)cudaErrorLaunchOutOfResources;
  while (cs < kClusterMax) {
    const int more = max_active_clusters(kern, 2 * cs, smem_of(2 * cs));
    if (more < 0) return more;
    if (more < chains) break;
    cs *= 2;
  }
  return cs;
}

// The cluster size for `chains` independent K x K chains whose slabs hold
// the compute type C: the smallest power of two whose slab fits the
// shared memory one block may opt in to, doubled while the chains'
// clusters of the doubled size still fit on the card at once, up to
// kClusterMax; 0 when no cluster holds the block (the caller's one-block
// route).  A negative cudaError_t code on failure.
template <typename C, typename Kernel>
int cluster_size_for(Kernel kern, int chains, int k) {
  if (k <= 0 || chains <= 0) return -(int)cudaErrorInvalidValue;
  if (k > 2 * kClusterThreads) return 0;
  const size_t optin = (size_t)smem_optin();
  int cs = 1;
  while (cs <= kClusterMax && slab_smem_bytes<C>(k, cs, true) > optin) cs *= 2;
  if (cs > kClusterMax) return 0;
  return grow_cluster(kern, chains, cs, [k](int c) { return slab_smem_bytes<C>(k, c, true); });
}

}  // namespace sap
