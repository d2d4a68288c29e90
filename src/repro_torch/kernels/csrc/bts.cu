// Block-tridiagonal solve of P factored chains for R right-hand sides
// (the SaP preconditioner apply).
//
// Replaces the TPU kernels repro/kernels/bts.py:_fwd_kernel and _bwd_kernel
// (bts_pallas).  One thread block per partition runs both sweeps in one
// launch:
//   forward   y_0 = b_0,            y_j = b_j - L_j y_{j-1}
//   backward  x_{M-1} = Sinv y,     x_j = Sinv_j (y_j - F_j x_{j+1})
// The backward loop walks j from M-1 down, which takes the place of the
// TPU kernel's reversed index map.  y lives in the output x; the backward
// step stages y_j - F_j x_{j+1} in a K x R per-partition workspace.
//
// Bound: bytes.  Each apply reads sinv, l and f once (3 M K^2 floats per
// partition) for ~6 M K^2 R flops, 0.5 flop per byte at R = 1.  For R <= 8
// a warp owns a few output rows at a time and its lanes read those rows of
// the K x K block with consecutive addresses, the loop unrolled so a
// lane keeps several loads in flight; wider R (whole spikes, R = K) uses
// the tiled block product.  One block per partition: at P <= 64 only P SMs
// pull from memory, which caps the achievable bandwidth.
#include "common.cuh"

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

extern "C" int bts_launch(const float* sinv, const float* l, const float* f, const float* b,
                          float* x, float* ws, int p, int m, int k, int r, void* stream) {
  bts_kernel<<<p, kThreads, 0, (cudaStream_t)stream>>>(sinv, l, f, b, x, ws, m, k, r);
  return (int)cudaGetLastError();
}
