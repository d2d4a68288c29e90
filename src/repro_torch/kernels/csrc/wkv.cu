// Chunked RWKV6 WKV recurrence (the SaP-scan along the sequence axis).
//
// Replaces the TPU kernel repro/kernels/wkv_chunk.py:_wkv_kernel
// (wkv6_pallas).  The recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T is a
// block lower-bidiagonal system in the states; each chunk of C tokens is
// solved locally and the D x D state carries the coupling to the next
// chunk.  Per chunk, with Lcum the inclusive cumulative sum of log w over
// the chunk and Lprev its exclusive form:
//   o_t   = (r_t * e^{Lprev_t}) @ S                                [inter]
//         + sum_{s<t} (sum_d r_td k_sd e^{Lprev_td - Lcum_sd}) v_s [intra]
//         + (r_t . u k_t) v_t                                      [bonus]
//   S_out = diag(e^{Llast}) S + (k * e^{Llast - Lcum})^T v
// Every exponent is a sum of log w <= 0, so nothing overflows, however
// strong the decay; exp(a - b) is never split into exp(a) * exp(-b).
//
// One thread block per (batch, head) row walks its chunks in order (the
// TPU grid's sequential chunk axis); the state stays in shared memory from
// the first chunk to the last.  The intra-chunk weights need the decay
// e^{Lprev_t - Lcum_s} per channel: the (C, C, D) tensor the TPU kernel
// materialises is 1 MiB at C = D = 64, so here each thread accumulates
// its G[t][s] over d in a register and only the (C, C) weights are kept.
// Chunk buffers use a row stride of D + 1 floats, so the lanes of a warp
// that walk s (or t) read distinct banks.
//
// Bound on the H100: at decode (C = 1) bytes -- the D x D state is read
// and written once per token; at prefill (C = 64) operations -- the
// intra term does C^2 D / 2 exponentials per chunk on the CUDA cores.
// float32 throughout, no tensor cores.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ s0, float* __restrict__ o,
               float* __restrict__ sout, int t, int d, int chunk) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* R = smem;             // C x dp: r, then r * e^{Lprev}
  float* K = R + chunk * dp;   // C x dp: k, then k * e^{Llast - Lcum}
  float* V = K + chunk * dp;   // C x dp
  float* L = V + chunk * dp;   // C x dp: log w, then Lcum
  float* S = L + chunk * dp;   // d x d carried state
  float* G = S + d * d;        // C x C intra-chunk weights
  float* U = G + chunk * chunk;  // d: the bonus u of this head
  float* Bn = U + d;           // C: the bonus r_t . u k_t

  const int tid = threadIdx.x, nt = blockDim.x;
  const long row = blockIdx.x;
  const long seq = row * t * d;
  for (int i = tid; i < d * d; i += nt) S[i] = s0[row * d * d + i];
  for (int i = tid; i < d; i += nt) U[i] = u[row * d + i];

  for (int c0 = 0; c0 < t; c0 += chunk) {
    __syncthreads();  // the previous chunk's state update has read its buffers
    for (int i = tid; i < chunk * d; i += nt) {
      const int tt = i / d, dd = i % d;
      const long gi = seq + (long)(c0 + tt) * d + dd;
      R[tt * dp + dd] = r[gi];
      K[tt * dp + dd] = k[gi];
      V[tt * dp + dd] = v[gi];
      L[tt * dp + dd] = logw[gi];
    }
    __syncthreads();
    // threads [0, d) scan one channel each; the next C threads form one bonus each
    for (int i = tid; i < d + chunk; i += nt) {
      if (i < d) {
        float acc = 0.f;
        for (int tt = 0; tt < chunk; ++tt) {
          acc += L[tt * dp + i];
          L[tt * dp + i] = acc;
        }
      } else {
        const int tt = i - d;
        float acc = 0.f;
        for (int dd = 0; dd < d; ++dd) acc += R[tt * dp + dd] * U[dd] * K[tt * dp + dd];
        Bn[tt] = acc;
      }
    }
    __syncthreads();
    // G[t][s] = sum_d r_td k_sd e^{Lprev_td - Lcum_sd} for s < t (Lprev_t = Lcum_{t-1})
    for (int i = tid; i < chunk * chunk; i += nt) {
      const int tt = i / chunk, ss = i % chunk;
      float acc = 0.f;
      if (ss < tt) {
        const float* rt = R + tt * dp;
        const float* lp = L + (tt - 1) * dp;
        const float* ks = K + ss * dp;
        const float* ls = L + ss * dp;
        for (int dd = 0; dd < d; ++dd) acc = fmaf(rt[dd] * ks[dd], expf(lp[dd] - ls[dd]), acc);
      }
      G[i] = acc;
    }
    __syncthreads();
    const float* llast = L + (chunk - 1) * dp;
    for (int i = tid; i < chunk * d; i += nt) {
      const int tt = i / d, dd = i % d;
      const float lprev = tt ? L[(tt - 1) * dp + dd] : 0.f;
      R[tt * dp + dd] *= expf(lprev);
      K[tt * dp + dd] *= expf(llast[dd] - L[tt * dp + dd]);
    }
    __syncthreads();
    for (int i = tid; i < chunk * d; i += nt) {
      const int tt = i / d, j = i % d;
      float inter = 0.f, intra = 0.f;
      for (int dd = 0; dd < d; ++dd) inter = fmaf(R[tt * dp + dd], S[dd * d + j], inter);
      for (int ss = 0; ss < tt; ++ss) intra = fmaf(G[tt * chunk + ss], V[ss * dp + j], intra);
      o[seq + (long)(c0 + tt) * d + j] = (inter + intra) + Bn[tt] * V[tt * dp + j];
    }
    __syncthreads();  // every output has read the chunk's incoming state
    for (int i = tid; i < d * d; i += nt) {
      const int dd = i / d, j = i % d;
      float acc = 0.f;
      for (int ss = 0; ss < chunk; ++ss) acc = fmaf(K[ss * dp + dd], V[ss * dp + j], acc);
      S[i] = expf(llast[dd]) * S[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < d * d; i += nt) sout[row * d * d + i] = S[i];
}

size_t wkv_smem_bytes(int d, int chunk) {
  return sizeof(float) * ((size_t)4 * chunk * (d + 1) + (size_t)d * d + (size_t)chunk * chunk +
                          d + chunk);
}

}  // namespace

// r, k, v, logw, o: (bh, t, d); u: (bh, d); s0, sout: (bh, d, d); t a
// multiple of chunk.  Returns a cudaError_t code.
extern "C" int wkv_launch(const float* r, const float* k, const float* v, const float* logw,
                          const float* u, const float* s0, float* o, float* sout, int bh, int t,
                          int d, int chunk, void* stream) {
  if (bh <= 0 || chunk <= 0 || t % chunk != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = wkv_smem_bytes(d, chunk);
  cudaError_t err =
      cudaFuncSetAttribute(wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<<<bh, kScanThreads, smem, (cudaStream_t)stream>>>(r, k, v, logw, u, s0, o, sout, t,
                                                                d, chunk);
  return (int)cudaGetLastError();
}
