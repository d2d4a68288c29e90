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
// other, so here each partition gets two thread blocks (grid P x 2): side 0
// runs the LU recurrence with c_w and writes sinv, l and
//   v_bot = sinv_{M-1} B,  w_bot = sinv_{M-1} c_w;
// side 1 runs the UL recurrence with c_v and writes
//   w_top = flip(c_ul flip(C)),  v_top = flip(c_ul c_v).
// The reversed chain is read through flipped views x[K-1-r, K-1-c], never
// copied.
//
// Bound: operations.  Per block row two inverses and six K x K products
// (~16 K^3 flops) on 3 K^2 floats read and 2 K^2 written.  Each side keeps
// its running inverse in its shared-memory elimination block (160 KB at
// K = 200) and its spike carry, double-buffered, plus the UL multiplier in
// an L2-resident device workspace; two blocks per partition put 2P blocks
// on the card (128 of 132 SMs at P = 64).
#include "common.cuh"

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

// Floats of device workspace each partition needs.
extern "C" long fused_workspace_floats(int k) {
  int w_in_smem = 0;
  gj_smem_bytes(k, &w_in_smem);
  return 2L * (w_in_smem ? 3L : 4L) * k * k;
}

extern "C" int fused_launch(const float* d, const float* e, const float* f, const float* bq,
                            const float* cq, float* sinv, float* l, float* vb, float* vt, float* wt,
                            float* wb, float* ws, int p, int m, int k, float boost_eps,
                            void* stream) {
  int w_in_smem = 0;
  const size_t smem = gj_smem_bytes(k, &w_in_smem);
  cudaError_t err =
      cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<<<dim3(p, 2), kThreads, smem, (cudaStream_t)stream>>>(
      d, e, f, bq, cq, sinv, l, vb, vt, wt, wb, ws, m, k, boost_eps, w_in_smem);
  return (int)cudaGetLastError();
}
