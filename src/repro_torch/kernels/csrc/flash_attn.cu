// Causal / sliding-window GQA flash attention (the transformer prefill).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:_flash_kernel
// (flash_attention_pallas).  The function: for query row t of head h,
//   o_t = sum_s softmax_s(q_t . k_s / sqrt(D)) v_s
// over the keys s visible to t (s < Tk; s <= t when causal; t - s < window
// when a window is given), with key/value head h / (Hq / Hk) (GQA).  It is
// computed by the online softmax over key tiles: the running row maximum m,
// the running sum l and the D-wide accumulator are rescaled by
// exp(m_old - m_new) at each tile, and the (Tq, Tk) scores never exist.
//
// One thread block per (batch, query head, 64-row query tile); the TPU
// kernel's interleaved (B*Hk, nq*G*Bq, D) fold of the G query heads, which
// feeds its 128-row matrix unit, is not carried over.  The block walks the
// key tiles of 64 that its masks leave (the TPU kernel's block skip:
// causal, k_start <= q_end; window, k_end >= q_start - (window - 1)), with
// the query tile, one key tile and one value tile in shared memory.  Each
// of the 256 threads owns 4 query rows (ty*4 + i) and, in the score tile,
// the 4 keys tx + 16 j; its rows' m, l and D-wide accumulator (the columns
// tx + 16 j) stay in registers.  A row's maximum and sum are reduced over
// the 16 lanes that share it by warp shuffles.  The probabilities go
// through shared memory (over the key tile, no longer needed) for P V.
// Scores are kept in base-2 units: q is scaled by log2(e) / sqrt(D) as it
// is loaded, and exp2 takes the place of exp.  Masked scores are the
// finite -1e30 of the TPU kernel, not -inf, so a row whose first visited
// tile is fully masked gets p = exp(0) = 1 there, and the first tile with a
// visible key wipes that out through corr = exp(-1e30 - m) = 0, exactly as
// the TPU kernel and the plain version do.  Keys and values past Tk are
// loaded as zeros; query rows past Tq are computed and not stored.
//
// Inputs bfloat16 or float32 (converted to float32 as loaded), output in
// the inputs' type (bfloat16 rounded to nearest even, as torch rounds).
// float32 FMA on the CUDA cores: no tensor cores.  Bound on the H100:
// operations -- 4 D + 1 per visible (query, key) pair and query head
// against 67 TFLOP/s (at Minitron-8B's prefill, T = 4096, D = 128: 2.06
// ms; its bytes, q, k, v and o once, 0.025 ms).  Shared memory holds each
// key and value tile once for 64 query rows, and 4 x 4 register tiles do
// 16 FMAs for every 8 shared loads in Q K^T.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per thread block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;  // 16 x 16: 4 query rows and 4 keys a thread
static_assert(kBQ == kBK, "load_tile loads 64-row tiles of q, k and v alike");
constexpr int kPld = kBQ + 4;  // row stride of the transposed probabilities
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ inline void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// 8 bfloat16 in one 16-byte load; a bfloat16 is the high half of its float32
__device__ inline void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// dst[r * ld + c] = mul * src[(row0 + r) * d + c] for the 64 rows of a
// tile, zero for rows at or past nrows; 8 consecutive elements a thread
// (d is a multiple of 8, so every load is 16- or 32-byte aligned).
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int nrows, int d,
                          float mul) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < kBK * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    float x[8];
    if (row0 + r < nrows) {
      load8(src + (long)(row0 + r) * d + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
    out[0] = make_float4(mul * x[0], mul * x[1], mul * x[2], mul * x[3]);
    out[1] = make_float4(mul * x[4], mul * x[5], mul * x[6], mul * x[7]);
  }
}

// NJ: output columns a thread owns (tx + 16 j, j < NJ), so D <= 16 NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int hq, int hk, int tq, int tk, int d, int causal, int window,
                 float qscale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* Qs = smem;                             // kBQ x ld, scaled by qscale
  float* Ks = Qs + kBQ * ld;                    // kBK x ld
  float* Ps = Ks;                               // kBK x kPld: P^T, over the key tile
  float* Vs = Ks + kBK * (ld > kPld ? ld : kPld);  // kBK x d

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, bb = blockIdx.z;
  const int q_start = qt * kBQ;
  const long qoff = ((long)bb * hq + h) * tq * d;
  const long kvoff = ((long)bb * hk + h / (hq / hk)) * tk * d;

  // the key tiles this query tile visits (the TPU kernel's block skip)
  int kt_hi = (tk + kBK - 1) / kBK - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + kBQ - 1) / kBK);
  int kt_lo = 0;
  if (window > 0) {
    const int lo = q_start - (window - 1) - (kBK - 1);  // least k_start that runs
    if (lo > 0) kt_lo = (lo + kBK - 1) / kBK;
  }

  load_tile(Qs, ld, q + qoff, q_start, tq, d, qscale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the previous tile's P and V have been read
    load_tile(Ks, ld, k + kvoff, k_start, tk, d, 1.f);
    load_tile(Vs, d, v + kvoff, k_start, tk, d, 1.f);
    __syncthreads();

    // scores of rows ty*4 + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < d; dd += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * ld + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          s[i][j] = fmaf(qa[i].w, kb[j].w, a);
        }
    }

    // masks, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_start + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_start + tx + 16 * j;
        const bool ok = kp < tk && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }

    __syncthreads();  // every thread has read the key tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * kPld + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V over the tile's 64 keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + c * kPld + ty * 4);
      const float* vr = Vs + c * d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float x = vr[col];
          acc[0][j] = fmaf(p.x, x, acc[0][j]);
          acc[1][j] = fmaf(p.y, x, acc[1][j]);
          acc[2][j] = fmaf(p.z, x, acc[2][j]);
          acc[3][j] = fmaf(p.w, x, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    if (qp >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + qoff + (long)qp * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) store(out + col, acc[i][j] / denom);
    }
  }
}

size_t flash_smem_bytes(int d) {
  const int ld = d + 4;
  return sizeof(float) * ((size_t)kBQ * ld + (size_t)kBK * (ld > kPld ? ld : kPld) +
                          (size_t)kBK * d);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hk, int tq,
           int tk, int d, int causal, int window, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBQ - 1) / kBQ, hq, b);
  const float qscale = kLog2e / sqrtf((float)d);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hk, tq, tk, d, causal, window, qscale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hk, int tq,
             int tk, int d, int causal, int window, cudaStream_t stream) {
  if (d <= 32) return launch<T, 2>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, stream);
  if (d <= 64) return launch<T, 4>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, stream);
  if (d <= 96) return launch<T, 6>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, stream);
  return launch<T, 8>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, stream);
}

}  // namespace

// q, o: (b, hq, tq, d); k, v: (b, hk, tk, d); contiguous, all bfloat16
// (bf16 != 0) or all float32.  window <= 0: no window.  Returns a
// cudaError_t code; cudaErrorInvalidValue for shapes the kernel does not
// take (d not a multiple of 8 in [8, 128], hq not a multiple of hk).
extern "C" int flash_launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                            int hk, int tq, int tk, int d, int causal, int window, int bf16,
                            void* stream) {
  if (b <= 0 || hq <= 0 || hk <= 0 || hq % hk != 0 || tq <= 0 || tk < 0 || d < 8 || d > 128 ||
      d % 8 != 0 || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
  return dispatch<float>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
}
