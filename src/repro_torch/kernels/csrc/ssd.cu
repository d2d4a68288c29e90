// Chunked Mamba-2 SSD recurrence (the SaP-scan along the sequence axis).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py:_ssd_kernel
// (ssd_pallas).  The recurrence h_t = e^{a_t} h_{t-1} + b_t x_t^T with a
// scalar decay per head and step; per chunk of C tokens, with Lcum the
// inclusive cumulative sum of a over the chunk:
//   G     = (C B^T) * e^{Lcum_t - Lcum_s}, masked to s <= t     (C x C)
//   y     = e^{Lcum} * (C @ S) + G @ X                         (C x P)
//   S_out = e^{Llast} S + (B * e^{Llast - Lcum})^T X           (N x P)
// Every exponent is <= 0.  The scalar decay lets the intra term factor
// into two products, with one exponential per (t, s) pair.
//
// One thread block per (batch, head) row walks its chunks in order; the
// N x P state stays in shared memory throughout.  B and C are shared by
// the heads of a token in Mamba-2 (Zamba2 broadcasts them over heads):
// row i reads b and c row i / hshare, so the wrapper passes them once per
// batch row (hshare = H) instead of H copies.  Chunk buffers use a row
// stride of width + 1 floats, so lanes walking s read distinct banks.
//
// Bound on the H100: at decode (C = 1) bytes -- the N x P state is read
// and written once per token; at prefill (C = 64) operations, ~4 C N P
// flops per chunk in the products.  float32 throughout, no tensor cores.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ b,
               const float* __restrict__ c, const float* __restrict__ loga,
               const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sout,
               int t, int n, int p, int chunk, int hshare) {
  extern __shared__ float smem[];
  const int pp = p + 1, np = n + 1;
  float* X = smem;              // C x pp
  float* Bm = X + chunk * pp;   // C x np: b, then b * e^{Llast - Lcum}
  float* Cm = Bm + chunk * np;  // C x np
  float* S = Cm + chunk * np;   // n x p carried state
  float* G = S + n * p;         // C x C intra-chunk weights
  float* Lc = G + chunk * chunk;  // C: a, then Lcum

  const int tid = threadIdx.x, nt = blockDim.x;
  const long row = blockIdx.x, brow = row / hshare;
  for (int i = tid; i < n * p; i += nt) S[i] = s0[row * n * p + i];

  for (int c0 = 0; c0 < t; c0 += chunk) {
    __syncthreads();  // the previous chunk's state update has read its buffers
    for (int i = tid; i < chunk * p; i += nt) {
      const int tt = i / p, j = i % p;
      X[tt * pp + j] = x[(row * t + c0 + tt) * p + j];
    }
    for (int i = tid; i < chunk * n; i += nt) {
      const int tt = i / n, j = i % n;
      const long gi = (brow * t + c0 + tt) * n + j;
      Bm[tt * np + j] = b[gi];
      Cm[tt * np + j] = c[gi];
    }
    for (int i = tid; i < chunk; i += nt) Lc[i] = loga[row * t + c0 + i];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int tt = 0; tt < chunk; ++tt) {
        acc += Lc[tt];
        Lc[tt] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < chunk * chunk; i += nt) {
      const int tt = i / chunk, ss = i % chunk;
      float g = 0.f;
      if (ss <= tt) {
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(Cm[tt * np + j], Bm[ss * np + j], acc);
        g = acc * expf(Lc[tt] - Lc[ss]);
      }
      G[i] = g;
    }
    __syncthreads();
    const float llast = Lc[chunk - 1];
    for (int i = tid; i < chunk * p; i += nt) {
      const int tt = i / p, j = i % p;
      float inter = 0.f, intra = 0.f;
      for (int q = 0; q < n; ++q) inter = fmaf(Cm[tt * np + q], S[q * p + j], inter);
      for (int ss = 0; ss <= tt; ++ss) intra = fmaf(G[tt * chunk + ss], X[ss * pp + j], intra);
      y[(row * t + c0 + tt) * p + j] = expf(Lc[tt]) * inter + intra;
    }
    // the outputs above do not read B: scale it for the state update meanwhile
    for (int i = tid; i < chunk * n; i += nt) {
      const int tt = i / n, j = i % n;
      Bm[tt * np + j] *= expf(llast - Lc[tt]);
    }
    __syncthreads();  // every output has read the chunk's incoming state
    for (int i = tid; i < n * p; i += nt) {
      const int q = i / p, j = i % p;
      float acc = 0.f;
      for (int ss = 0; ss < chunk; ++ss) acc = fmaf(Bm[ss * np + q], X[ss * pp + j], acc);
      S[i] = expf(llast) * S[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += nt) sout[row * n * p + i] = S[i];
}

size_t ssd_smem_bytes(int n, int p, int chunk) {
  return sizeof(float) * ((size_t)chunk * (p + 1) + (size_t)2 * chunk * (n + 1) +
                          (size_t)n * p + (size_t)chunk * chunk + chunk);
}

}  // namespace

// x, y: (bh, t, p); b, c: (bh / hshare, t, n); loga: (bh, t); s0, sout:
// (bh, n, p); t a multiple of chunk, bh a multiple of hshare.  Returns a
// cudaError_t code.
extern "C" int ssd_launch(const float* x, const float* b, const float* c, const float* loga,
                          const float* s0, float* y, float* sout, int bh, int t, int n, int p,
                          int chunk, int hshare, void* stream) {
  if (bh <= 0 || chunk <= 0 || t % chunk != 0 || hshare <= 0 || bh % hshare != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_smem_bytes(n, p, chunk);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<bh, kScanThreads, smem, (cudaStream_t)stream>>>(x, b, c, loga, s0, y, sout, t, n,
                                                                p, chunk, hshare);
  return (int)cudaGetLastError();
}
