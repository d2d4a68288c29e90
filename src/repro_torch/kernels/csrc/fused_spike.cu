// Fused block-LU factor + spike-corner extraction (SaP-C/E factor stage).
//
// Replaces the TPU kernel repro/kernels/fused_spike.py:_fused_kernel
// (fused_factor_spike_pallas).  The TPU kernel makes one ascending pass
// j = 0..M-1 per partition with four K x K carries:
//   c_lu  inv(S_{j-1}) of the LU recurrence;
//   c_w   the left-spike RHS swept through LU:  y_0 = C,  y_j = -l_j y_{j-1};
//   c_ul  the same recurrence on the reversed chain (the UL factorization),
//         reading d[M-1-j], f[M-1-j] and e[M-j] flipped on both axes;
//   c_v   the right-spike RHS swept through UL: y_0 = flip(B), y_j = -l^UL_j y_{j-1}.
// The LU pair (c_lu, c_w) and the UL pair (c_ul, c_v) never read each
// other, so each partition runs them side by side: side 0 runs the LU
// recurrence with c_w and writes sinv, l and
//   v_bot = sinv_{M-1} B,  w_bot = sinv_{M-1} c_w;
// side 1 runs the UL recurrence with c_v and writes
//   w_top = flip(c_ul flip(C)),  v_top = flip(c_ul c_v).
// The reversed chain is read through flipped views x[K-1-r, K-1-c], never
// copied.
//
// Bound: operations.  Per block row two inverses and six K x K products
// (~16 K^3 flops) on 3 K^2 floats read and 2 K^2 written.  Design
// (fused_cluster_kernel): each side of each partition runs on a thread-
// block cluster of cs CTAs, grid (P cs, 2), CTA r owning rows
// [r R, r R + R) of the side's running inverse in its shared memory, as
// btf.cu does (gj_cluster.cuh).  Per block row a side forms its
// multiplier's rows (the previous inverse read back from device memory:
// sinv, or the UL inverse's workspace slot), its next pivot block's rows
// into the slab, and its rows of the spike carry, then inverts on the
// cluster.  The carry is double-buffered in a device workspace
// (L2-resident) since each CTA's product needs all of the previous one;
// the UL multiplier's rows go there too.  The four corner
// products at j = M-1 are split by the rows of the inverse each CTA owns
// (side 1's flipped: output row K-1-i from row i).  The cluster size comes
// from the shape (fused_cluster_size): the smallest that holds the block,
// doubled while the 2P clusters still fit on the card at once -- 1 CTA a
// side at P = 64, K = 200.  Blocks that no cluster of 16 holds take
// fused_kernel, one thread block a side with the block in device memory.
//
// Storage types (common.cuh): float32, bfloat16 and float64, each with
// its own entry points (fused_launch, fused_launch_bf16,
// fused_launch_f64); bfloat16 computes in float32, float64 in float64.
// The carries and the UL side's multiplier and inverse are always in the
// compute type in the workspace; for bfloat16 the LU side's multiplier
// and last inverse go through the same workspace slots and sinv, l and
// the corners are stored rounded once.
#include "gj_cluster.cuh"

using namespace sap;

// Workspace per (partition, side), in the compute type: carry[2] | l_ul |
// (W).  Side 0 keeps its multiplier L_j in the l_ul slot when T != C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ f,
                 const T* __restrict__ bq, const T* __restrict__ cq, T* sinv, T* l, T* vb, T* vt,
                 T* wt, T* wb, Compute<T>* ws, int m, int k, Compute<T> boost_eps, int w_in_smem) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* red = reinterpret_cast<C*>(smem_raw);
  C* rowbuf = red + kRed;
  C* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  const int side = blockIdx.y;  // 0: LU chain + left spike, 1: UL chain + right spike
  C* slot = ws + ((long)blockIdx.x * 2 + side) * (w_in_smem ? 3 : 4) * kk;
  C* carry[2] = {slot, slot + kk};
  C* l_ul = slot + 2 * kk;
  C* W = w_in_smem ? colbuf + k : slot + 3 * kk;
  const long base = (long)blockIdx.x * m * kk;
  const long co = (long)blockIdx.x * kk;
  const T* bqp = bq + co;
  const T* cqp = cq + co;

  if (side == 0) {
    block_copy<C>(rowmajor(W, k), rowmajor(d + base, k), k, k);
    for (long i = threadIdx.x; i < kk; i += blockDim.x) l[base + i] = conv<T>(C(0));
    block_copy<C>(rowmajor(carry[0], k), rowmajor(cqp, k), k, k);
  } else {
    block_copy<C>(rowmajor(W, k), flip2(d + base + (m - 1) * kk, k), k, k);
    block_copy<C>(rowmajor(carry[0], k), fliprows(bqp, k, k), k, k);
  }
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  if (side == 0) block_copy<C>(rowmajor(sinv + base, k), rowmajor(W, k), k, k);
  __syncthreads();

  for (int j = 1; j < m; ++j) {
    const int cur = j & 1, prv = cur ^ 1;
    if (side == 0) {
      // l_j = e_j inv(S_{j-1});  S_j = d_j - l_j f_{j-1};  c_w <- -(l_j c_w)
      const long off = base + j * kk;
      C* lj = same ? reinterpret_cast<C*>(l + off) : l_ul;
      block_gemm(rowmajor(lj, k), rowmajor(e + off, k), rowmajor(W, k), none<C>(), C(1), k, k, k);
      __syncthreads();
      block_gemm(rowmajor(W, k), rowmajor(lj, k), rowmajor(f + off - kk, k), rowmajor(d + off, k),
                 C(-1), k, k, k);
      block_gemm(rowmajor(carry[cur], k), rowmajor(lj, k), rowmajor(carry[prv], k), none<C>(),
                 C(-1), k, k, k);
      if (!same) block_copy<C>(rowmajor(l + off, k), rowmajor(lj, k), k, k);
      __syncthreads();
      gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
      block_copy<C>(rowmajor(sinv + off, k), rowmajor(W, k), k, k);
    } else {
      // reversed chain: d_r = flip2(d[M-1-j]), e_r = flip2(f[M-1-j]),
      // f_r[j-1] = flip2(e[M-j]);  c_v <- -(l_ul c_v)
      const long rj = base + (long)(m - 1 - j) * kk;
      block_gemm(rowmajor(l_ul, k), flip2(f + rj, k), rowmajor(W, k), none<C>(), C(1), k, k, k);
      __syncthreads();
      block_gemm(rowmajor(W, k), rowmajor(l_ul, k), flip2(e + rj + kk, k), flip2(d + rj, k), C(-1),
                 k, k, k);
      block_gemm(rowmajor(carry[cur], k), rowmajor(l_ul, k), rowmajor(carry[prv], k), none<C>(),
                 C(-1), k, k, k);
      __syncthreads();
      gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
    }
    __syncthreads();
  }

  // j = M-1: the spike corners; W holds sinv_{M-1} (side 0) or the UL
  // inverse (side 1)
  const int last = (m - 1) & 1;
  if (side == 0) {
    block_gemm(rowmajor(vb + co, k), rowmajor(W, k), rowmajor(bqp, k), none<C>(), C(1), k, k, k);
    block_gemm(rowmajor(wb + co, k), rowmajor(W, k), rowmajor(carry[last], k), none<C>(), C(1), k,
               k, k);
  } else {
    block_gemm(rowmajor(wt + co, k), fliprows(W, k, k), fliprows(cqp, k, k), none<C>(), C(1), k, k,
               k);
    block_gemm(rowmajor(vt + co, k), fliprows(W, k, k), rowmajor(carry[last], k), none<C>(), C(1),
               k, k, k);
  }
}

// Mat m starting at row r0.
template <typename E>
__device__ inline Mat<E> from_row(Mat<E> m, int r0) {
  return Mat<E>{m.p + r0 * m.rs, m.rs, m.cs};
}

// grid (P cs, 2 sides), cluster (cs), kClusterThreads threads; workspace
// per (partition, side), in the compute type: carry[2] | the multiplier |
// the last inverse, 4 K^2 (side 0 uses the last two only when T != C).
template <int NC, typename T>
__global__ void __launch_bounds__(kClusterThreads)
    fused_cluster_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ f,
                         const T* __restrict__ bq, const T* __restrict__ cq, T* sinv, T* l, T* vb,
                         T* vt, T* wt, T* wb, Compute<T>* ws, int m, int k, Compute<T> boost_eps) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab<C> s = make_slab(reinterpret_cast<C*>(smem_raw), k, cs, (int)cluster.block_rank(), true);
  const int n = s.nrows, row0 = s.row0;
  const int part = blockIdx.x / cs, side = blockIdx.y;  // 0: LU + left spike, 1: UL + right spike
  const long kk = (long)k * k, mine = (long)row0 * k;
  C* slot = ws + ((long)part * 2 + side) * 4 * kk;
  C* carry[2] = {slot, slot + kk};
  C* mult_c = slot + 2 * kk;  // the multiplier (UL side; LU side when T != C)
  C* inv_c = slot + 3 * kk;   // the last inverse (likewise)
  const bool lu_out = side == 0 && same;  // the LU side carries through its outputs
  const long chain = (long)part * m * kk, co = (long)part * kk;
  const T* bqp = bq + co;
  const T* cqp = cq + co;

  C mx;
  if (side == 0) {
    mx = slab_load(s, rowmajor(d + chain + mine, k), n);
    for (long i = threadIdx.x; i < (long)n * k; i += kClusterThreads) {
      l[chain + mine + i] = conv<T>(C(0));
      carry[0][mine + i] = conv<C>(cqp[mine + i]);
    }
  } else {
    mx = slab_load(s, from_row(flip2(d + chain + (m - 1) * kk, k), row0), n);
    block_copy<C>(from_row(rowmajor(carry[0], k), row0), from_row(fliprows(bqp, k, k), row0), n,
                  k);
  }
  C scale = cluster_max(cluster, mx, s.red);
  gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));
  if (side == 0) slab_store(s, rowmajor(sinv + chain + mine, k), n);
  if (!lu_out) slab_store(s, rowmajor(inv_c + mine, k), n);

  for (int j = 1; j < m; ++j) {
    const int cur = j & 1, prv = cur ^ 1;
    // the multiplier's rows (l_j, or the UL multiplier) and the operands of
    // the next pivot block: side 0  l_j = e_j inv(S_{j-1}),
    // S_j = d_j - l_j f_{j-1};  side 1 (reversed chain) d_r = flip2(d[M-1-j]),
    // e_r = flip2(f[M-1-j]), f_r[j-1] = flip2(e[M-j])
    const long blk = chain + (long)(side == 0 ? j : m - 1 - j) * kk;
    const C* inv_prev = lu_out ? reinterpret_cast<const C*>(sinv + blk - kk) : inv_c;
    C* mult = lu_out ? reinterpret_cast<C*>(l + blk + mine) : mult_c + mine;
    const Mat<T> a_sub =
        side == 0 ? rowmajor(e + blk + mine, k) : from_row(flip2(f + blk, k), row0);
    const Mat<T> b_sup = side == 0 ? rowmajor(f + blk - kk, k) : flip2(e + blk + kk, k);
    const Mat<T> a_diag =
        side == 0 ? rowmajor(d + blk + mine, k) : from_row(flip2(d + blk, k), row0);
    cluster.sync();  // every CTA's rows of the previous inverse are in memory
    slab_product(s, rowmajor(mult, k), a_sub, rowmajor(inv_prev, k), none<C>(), C(1), n, k, k);
    __syncthreads();  // the multiplier's rows are written
    mx = slab_product(s, rowmajor(s.w, s.ld), rowmajor(mult, k), b_sup, a_diag, C(-1), n, k, k);
    // the spike carry: c <- -(mult c), all of the previous carry read
    slab_product(s, rowmajor(carry[cur] + mine, k), rowmajor(mult, k), rowmajor(carry[prv], k),
                 none<C>(), C(-1), n, k, k);
    if (side == 0) rows_out(l + blk + mine, mult, (long)n * k);
    scale = cluster_max(cluster, mx, s.red);  // every CTA has also read inv and carry[prv]
    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));
    if (side == 0) slab_store(s, rowmajor(sinv + blk + mine, k), n);
    if (!lu_out) slab_store(s, rowmajor(inv_c + mine, k), n);
  }

  // j = M-1: the spike corners from this CTA's rows of the last inverse
  // (every CTA's rows of the last carry were written before the last
  // inversion's cluster barriers)
  C* last = carry[(m - 1) & 1];
  if (side == 0) {
    const Mat<C> w = rowmajor(s.w, s.ld);
    slab_product(s, rowmajor(vb + co + mine, k), w, rowmajor(bqp, k), none<C>(), C(1), n, k, k);
    slab_product(s, rowmajor(wb + co + mine, k), w, rowmajor(last, k), none<C>(), C(1), n, k, k);
  } else if (n > 0) {
    // output row K-1-(row0+i) takes row i of the slab: rows flipped
    const Mat<C> w = Mat<C>{s.w + (long)(n - 1) * s.ld, -s.ld, 1};
    const long out = co + (long)(k - row0 - n) * k;
    slab_product(s, rowmajor(wt + out, k), w, fliprows(cqp, k, k), none<C>(), C(1), n, k, k);
    slab_product(s, rowmajor(vt + out, k), w, rowmajor(last, k), none<C>(), C(1), n, k, k);
  }
}

namespace {

template <typename T>
using FusedClusterKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, T*, T*,
                                    T*, T*, T*, Compute<T>*, int, int, Compute<T>);

template <typename T>
FusedClusterKernel<T> cluster_kernel(int k) {
  return k > kClusterThreads ? fused_cluster_kernel<2, T> : fused_cluster_kernel<1, T>;
}

template <typename T>
int cluster_size_t(int p, int k) {
  if (k <= 0 || p <= 0) return -(int)cudaErrorInvalidValue;
  return cluster_size_for<Compute<T>>(cluster_kernel<T>(k), 2 * p, k);
}

template <typename T>
long workspace_elems_t(int k, int cluster) {
  int w_in_smem = 0;
  if (cluster == 0) gj_smem_bytes<Compute<T>>(k, &w_in_smem);
  return 2L * (w_in_smem ? 3L : 4L) * k * k;
}

template <typename T>
int launch_t(const T* d, const T* e, const T* f, const T* bq, const T* cq, T* sinv, T* l, T* vb,
             T* vt, T* wt, T* wb, Compute<T>* ws, int p, int m, int k, Compute<T> boost_eps,
             int cluster, void* stream) {
  using C = Compute<T>;
  if (p <= 0 || m <= 0 || k <= 0 || cluster < 0 || cluster > kClusterMax || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    int w_in_smem = 0;
    const size_t smem = gj_smem_bytes<C>(k, &w_in_smem);
    cudaError_t err = cudaFuncSetAttribute(fused_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_kernel<T><<<dim3(p, 2), kThreads, smem, (cudaStream_t)stream>>>(
        d, e, f, bq, cq, sinv, l, vb, vt, wt, wb, ws, m, k, boost_eps, w_in_smem);
    return (int)cudaGetLastError();
  }
  const size_t smem = slab_smem_bytes<C>(k, cluster, true);
  if (k > 2 * kClusterThreads || smem > (size_t)smem_optin()) return (int)cudaErrorInvalidValue;
  const FusedClusterKernel<T> kern = cluster_kernel<T>(k);
  const int active = max_active_clusters(kern, cluster, smem);
  if (active < 0) return -active;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(p * cluster, 2), cluster, smem, (cudaStream_t)stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, d, e, f, bq, cq, sinv, l, vb, vt, wt, wb, ws, m,
                                       k, boost_eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// For each storage type (SAP_DTYPE_ENTRIES: fused_launch, fused_launch_bf16,
// fused_launch_f64, and the same suffixes on the other two):
//
// fused_cluster_size: the cluster size a fused launch of P partitions (2P
// chains: an LU and a UL side each) of K x K blocks takes: 1..16, or 0 for
// the one-block kernel; a negative cudaError_t code on failure.
//
// fused_workspace_floats: elements of the compute type of device workspace
// each partition needs on the route of a cluster size: carry[2], the
// multiplier and the last inverse a side; on the one-block route
// (cluster 0) carry[2] and the multiplier, and the elimination block
// unless it fits in shared memory.
//
// fused_launch: cluster is the size fused_cluster_size gives, or (tests)
// any size 1..16 whose slab fits; 0 launches the one-block kernel.  A size
// the card cannot schedule is an error, never a fallback.
#define FUSED_ENTRIES(T, SUF, C)                                                                \
  extern "C" int fused_cluster_size##SUF(int p, int k) { return cluster_size_t<T>(p, k); }      \
  extern "C" long fused_workspace_floats##SUF(int k, int cluster) {                             \
    return workspace_elems_t<T>(k, cluster);                                                    \
  }                                                                                             \
  extern "C" int fused_launch##SUF(const T* d, const T* e, const T* f, const T* bq, const T* cq, \
                                   T* sinv, T* l, T* vb, T* vt, T* wt, T* wb, C* ws, int p,      \
                                   int m, int k, C boost_eps, int cluster, void* stream) {       \
    return launch_t<T>(d, e, f, bq, cq, sinv, l, vb, vt, wt, wb, ws, p, m, k, boost_eps,        \
                       cluster, stream);                                                         \
  }
SAP_DTYPE_ENTRIES(FUSED_ENTRIES)
