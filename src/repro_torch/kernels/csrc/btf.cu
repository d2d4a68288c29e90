// Block-tridiagonal LU factorization of P independent chains (SaP factor).
//
// Replaces the TPU kernel repro/kernels/btf.py:_btf_kernel (btf_pallas).
// One thread block per partition walks the chain's M block rows:
//   S_0 = D_0,  L_j = E_j inv(S_{j-1}),  S_j = D_j - L_j F_{j-1},
// inverting every S_j in place by boosted Gauss-Jordan (common.cuh).
//
// Bound: operations.  Per block row ~6 K^3 flops (inverse 2 K^3, two
// products 4 K^3) on 3 K^2 floats read and 2 K^2 written, ~K/2 flops per
// byte.  The elimination block (160 KB at K = 200) sits in shared memory
// and the running inverse is read from there by the next step's product;
// chains with K too large for shared memory (the SaP-E reduced chain at
// 2K = 400) eliminate in a per-partition device workspace that L2 serves.
// Parallelism is one block per partition, so P <= 64 leaves SMs idle; the
// K x K products and the elimination use all 512 threads of the block.
#include "common.cuh"

using namespace sap;

__global__ void __launch_bounds__(kThreads)
    btf_kernel(const float* __restrict__ d, const float* __restrict__ e,
               const float* __restrict__ f, float* sinv, float* l, float* ws, int m, int k,
               float boost_eps, int w_in_smem) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rowbuf = red + kRed;
  float* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  float* W = w_in_smem ? colbuf + k : ws + blockIdx.x * kk;
  const long base = (long)blockIdx.x * m * kk;

  block_copy(rowmajor(W, k), rowmajor(d + base, k), k, k);
  for (long i = threadIdx.x; i < kk; i += blockDim.x) l[base + i] = 0.f;
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  block_copy(rowmajor(sinv + base, k), rowmajor(W, k), k, k);
  __syncthreads();

  for (int j = 1; j < m; ++j) {
    const long off = base + j * kk;
    // L_j = E_j @ inv(S_{j-1}); the inverse is still in W
    block_gemm(rowmajor(l + off, k), rowmajor(e + off, k), rowmajor(W, k), none(), 1.f, k, k, k);
    __syncthreads();
    // S_j = D_j - L_j @ F_{j-1}
    block_gemm(rowmajor(W, k), rowmajor(l + off, k), rowmajor(f + off - kk, k),
               rowmajor(d + off, k), -1.f, k, k, k);
    __syncthreads();
    gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
    block_copy(rowmajor(sinv + off, k), rowmajor(W, k), k, k);
    __syncthreads();
  }
}

// Floats of device workspace each partition needs (0 when the elimination
// block fits in shared memory).
extern "C" long btf_workspace_floats(int k) {
  int w_in_smem = 0;
  gj_smem_bytes(k, &w_in_smem);
  return w_in_smem ? 0 : (long)k * k;
}

extern "C" int btf_launch(const float* d, const float* e, const float* f, float* sinv, float* l,
                          float* ws, int p, int m, int k, float boost_eps, void* stream) {
  int w_in_smem = 0;
  const size_t smem = gj_smem_bytes(k, &w_in_smem);
  cudaError_t err =
      cudaFuncSetAttribute(btf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  btf_kernel<<<p, kThreads, smem, (cudaStream_t)stream>>>(d, e, f, sinv, l, ws, m, k, boost_eps,
                                                          w_in_smem);
  return (int)cudaGetLastError();
}
