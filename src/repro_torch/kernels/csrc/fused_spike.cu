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
#include "gj_cluster.cuh"

using namespace sap;

__global__ void __launch_bounds__(kThreads)
    fused_kernel(const float* __restrict__ d, const float* __restrict__ e,
                 const float* __restrict__ f, const float* __restrict__ bq,
                 const float* __restrict__ cq, float* sinv, float* l, float* vb, float* vt,
                 float* wt, float* wb, float* ws, int m, int k, float boost_eps, int w_in_smem) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rowbuf = red + kRed;
  float* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  const int side = blockIdx.y;  // 0: LU chain + left spike, 1: UL chain + right spike
  // workspace per (partition, side): carry[2] | l_ul | (W)
  float* slot = ws + ((long)blockIdx.x * 2 + side) * (w_in_smem ? 3 : 4) * kk;
  float* carry[2] = {slot, slot + kk};
  float* l_ul = slot + 2 * kk;
  float* W = w_in_smem ? colbuf + k : slot + 3 * kk;
  const long base = (long)blockIdx.x * m * kk;
  const long co = (long)blockIdx.x * kk;
  const float* bqp = bq + co;
  const float* cqp = cq + co;

  if (side == 0) {
    block_copy(rowmajor(W, k), rowmajor(d + base, k), k, k);
    for (long i = threadIdx.x; i < kk; i += blockDim.x) l[base + i] = 0.f;
    block_copy(rowmajor(carry[0], k), rowmajor(cqp, k), k, k);
  } else {
    block_copy(rowmajor(W, k), flip2(d + base + (m - 1) * kk, k), k, k);
    block_copy(rowmajor(carry[0], k), fliprows(bqp, k, k), k, k);
  }
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  if (side == 0) block_copy(rowmajor(sinv + base, k), rowmajor(W, k), k, k);
  __syncthreads();

  for (int j = 1; j < m; ++j) {
    const int cur = j & 1, prv = cur ^ 1;
    if (side == 0) {
      // l_j = e_j inv(S_{j-1});  S_j = d_j - l_j f_{j-1};  c_w <- -(l_j c_w)
      const long off = base + j * kk;
      block_gemm(rowmajor(l + off, k), rowmajor(e + off, k), rowmajor(W, k), none(), 1.f, k, k, k);
      __syncthreads();
      block_gemm(rowmajor(W, k), rowmajor(l + off, k), rowmajor(f + off - kk, k),
                 rowmajor(d + off, k), -1.f, k, k, k);
      block_gemm(rowmajor(carry[cur], k), rowmajor(l + off, k), rowmajor(carry[prv], k), none(),
                 -1.f, k, k, k);
      __syncthreads();
      gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
      block_copy(rowmajor(sinv + off, k), rowmajor(W, k), k, k);
    } else {
      // reversed chain: d_r = flip2(d[M-1-j]), e_r = flip2(f[M-1-j]),
      // f_r[j-1] = flip2(e[M-j]);  c_v <- -(l_ul c_v)
      const long rj = base + (long)(m - 1 - j) * kk;
      block_gemm(rowmajor(l_ul, k), flip2(f + rj, k), rowmajor(W, k), none(), 1.f, k, k, k);
      __syncthreads();
      block_gemm(rowmajor(W, k), rowmajor(l_ul, k), flip2(e + rj + kk, k), flip2(d + rj, k), -1.f,
                 k, k, k);
      block_gemm(rowmajor(carry[cur], k), rowmajor(l_ul, k), rowmajor(carry[prv], k), none(), -1.f,
                 k, k, k);
      __syncthreads();
      gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
    }
    __syncthreads();
  }

  // j = M-1: the spike corners; W holds sinv_{M-1} (side 0) or the UL
  // inverse (side 1)
  const int last = (m - 1) & 1;
  if (side == 0) {
    block_gemm(rowmajor(vb + co, k), rowmajor(W, k), rowmajor(bqp, k), none(), 1.f, k, k, k);
    block_gemm(rowmajor(wb + co, k), rowmajor(W, k), rowmajor(carry[last], k), none(), 1.f, k, k,
               k);
  } else {
    block_gemm(rowmajor(wt + co, k), fliprows(W, k, k), fliprows(cqp, k, k), none(), 1.f, k, k, k);
    block_gemm(rowmajor(vt + co, k), fliprows(W, k, k), rowmajor(carry[last], k), none(), 1.f, k, k,
               k);
  }
}

// Mat m starting at row r0.
__device__ inline Mat from_row(Mat m, int r0) { return Mat{m.p + r0 * m.rs, m.rs, m.cs}; }

// grid (P cs, 2 sides), cluster (cs), kClusterThreads threads; workspace
// per (partition, side): carry[2] | l_ul | the UL inverse, 4 K^2 floats.
template <int NC>
__global__ void __launch_bounds__(kClusterThreads)
    fused_cluster_kernel(const float* __restrict__ d, const float* __restrict__ e,
                         const float* __restrict__ f, const float* __restrict__ bq,
                         const float* __restrict__ cq, float* sinv, float* l, float* vb, float* vt,
                         float* wt, float* wb, float* ws, int m, int k, float boost_eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  extern __shared__ __align__(16) float smem[];
  const Slab s = make_slab(smem, k, cs, (int)cluster.block_rank(), true);
  const int n = s.nrows, row0 = s.row0;
  const int part = blockIdx.x / cs, side = blockIdx.y;  // 0: LU + left spike, 1: UL + right spike
  const long kk = (long)k * k, mine = (long)row0 * k;
  float* slot = ws + ((long)part * 2 + side) * 4 * kk;
  float* carry[2] = {slot, slot + kk};
  float* l_ul = slot + 2 * kk;
  float* inv_ul = slot + 3 * kk;
  const long chain = (long)part * m * kk, co = (long)part * kk;
  const float* bqp = bq + co;
  const float* cqp = cq + co;

  float mx;
  if (side == 0) {
    mx = slab_load(s, rowmajor(d + chain + mine, k), n);
    for (long i = threadIdx.x; i < (long)n * k; i += kClusterThreads) {
      l[chain + mine + i] = 0.f;
      carry[0][mine + i] = cqp[mine + i];
    }
  } else {
    mx = slab_load(s, from_row(flip2(d + chain + (m - 1) * kk, k), row0), n);
    block_copy(from_row(rowmajor(carry[0], k), row0), from_row(fliprows(bqp, k, k), row0), n, k);
  }
  float scale = cluster_max(cluster, mx, s.red);
  gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmaxf(scale, 1e-30f));
  slab_store(s, rowmajor((side == 0 ? sinv + chain : inv_ul) + mine, k), n);

  for (int j = 1; j < m; ++j) {
    const int cur = j & 1, prv = cur ^ 1;
    // the multiplier's rows (l_j, or the UL multiplier) and the operands of
    // the next pivot block: side 0  l_j = e_j inv(S_{j-1}),
    // S_j = d_j - l_j f_{j-1};  side 1 (reversed chain) d_r = flip2(d[M-1-j]),
    // e_r = flip2(f[M-1-j]), f_r[j-1] = flip2(e[M-j])
    const long blk = chain + (long)(side == 0 ? j : m - 1 - j) * kk;
    float* inv = side == 0 ? sinv + blk : inv_ul;  // where this row's inverse goes
    const Mat mult = side == 0 ? rowmajor(l + blk + mine, k) : rowmajor(l_ul + mine, k);
    const Mat a_sub = side == 0 ? rowmajor(e + blk + mine, k) : from_row(flip2(f + blk, k), row0);
    const Mat b_sup = side == 0 ? rowmajor(f + blk - kk, k) : flip2(e + blk + kk, k);
    const Mat a_diag = side == 0 ? rowmajor(d + blk + mine, k) : from_row(flip2(d + blk, k), row0);
    cluster.sync();  // every CTA's rows of the previous inverse are in memory
    slab_product(s, mult, a_sub, rowmajor(side == 0 ? inv - kk : inv, k), none(), 1.f, n, k, k);
    __syncthreads();  // the multiplier's rows are written
    mx = slab_product(s, rowmajor(s.w, s.ld), mult, b_sup, a_diag, -1.f, n, k, k);
    // the spike carry: c <- -(mult c), all of the previous carry read
    slab_product(s, rowmajor(carry[cur] + mine, k), mult, rowmajor(carry[prv], k), none(), -1.f, n,
                 k, k);
    scale = cluster_max(cluster, mx, s.red);  // every CTA has also read inv and carry[prv]
    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmaxf(scale, 1e-30f));
    slab_store(s, rowmajor(inv + mine, k), n);
  }

  // j = M-1: the spike corners from this CTA's rows of the last inverse
  // (every CTA's rows of the last carry were written before the last
  // inversion's cluster barriers)
  float* last = carry[(m - 1) & 1];
  if (side == 0) {
    const Mat w = rowmajor(s.w, s.ld);
    slab_product(s, rowmajor(vb + co + mine, k), w, rowmajor(bqp, k), none(), 1.f, n, k, k);
    slab_product(s, rowmajor(wb + co + mine, k), w, rowmajor(last, k), none(), 1.f, n, k, k);
  } else if (n > 0) {
    // output row K-1-(row0+i) takes row i of the slab: rows flipped
    const Mat w = Mat{s.w + (long)(n - 1) * s.ld, -s.ld, 1};
    const long out = co + (long)(k - row0 - n) * k;
    slab_product(s, rowmajor(wt + out, k), w, fliprows(cqp, k, k), none(), 1.f, n, k, k);
    slab_product(s, rowmajor(vt + out, k), w, rowmajor(last, k), none(), 1.f, n, k, k);
  }
}

namespace {

using FusedClusterKernel = void (*)(const float*, const float*, const float*, const float*,
                                    const float*, float*, float*, float*, float*, float*, float*,
                                    float*, int, int, float);

FusedClusterKernel cluster_kernel(int k) {
  return k > kClusterThreads ? fused_cluster_kernel<2> : fused_cluster_kernel<1>;
}

}  // namespace

// The cluster size a fused launch of P partitions (2P chains: an LU and a
// UL side each) of K x K blocks takes: 1..16, or 0 for the one-block
// kernel; a negative cudaError_t code on failure.
extern "C" int fused_cluster_size(int p, int k) {
  if (k <= 0 || p <= 0) return -(int)cudaErrorInvalidValue;
  return cluster_size_for(cluster_kernel(k), 2 * p, k);
}

// Floats of device workspace each partition needs on the route of a
// cluster size: carry[2], the UL multiplier and the UL inverse a side; on
// the one-block route (cluster 0) carry[2] and the UL multiplier, and the
// elimination block unless it fits in shared memory.
extern "C" long fused_workspace_floats(int k, int cluster) {
  int w_in_smem = 0;
  if (cluster == 0) gj_smem_bytes(k, &w_in_smem);
  return 2L * (w_in_smem ? 3L : 4L) * k * k;
}

// cluster: the size fused_cluster_size gives, or (tests) any size 1..16
// whose slab fits; 0 launches the one-block kernel.  A size the card
// cannot schedule is an error, never a fallback.
extern "C" int fused_launch(const float* d, const float* e, const float* f, const float* bq,
                            const float* cq, float* sinv, float* l, float* vb, float* vt, float* wt,
                            float* wb, float* ws, int p, int m, int k, float boost_eps, int cluster,
                            void* stream) {
  if (p <= 0 || m <= 0 || k <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    int w_in_smem = 0;
    const size_t smem = gj_smem_bytes(k, &w_in_smem);
    cudaError_t err =
        cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_kernel<<<dim3(p, 2), kThreads, smem, (cudaStream_t)stream>>>(
        d, e, f, bq, cq, sinv, l, vb, vt, wt, wb, ws, m, k, boost_eps, w_in_smem);
    return (int)cudaGetLastError();
  }
  const size_t smem = slab_smem_bytes(k, cluster, true);
  if (k > 2 * kClusterThreads || smem > (size_t)smem_optin()) return (int)cudaErrorInvalidValue;
  const FusedClusterKernel kern = cluster_kernel(k);
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
