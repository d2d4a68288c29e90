// Pieces shared by the two SaP-scan kernels (wkv.cu, ssd.cu): the route
// rule's limits, cp.async staging, the one-time shared-memory opt-in, and
// the split route's second launch (the carry).
//
// The scans run three routes, chosen by the wrapper from the shape:
//   step  (chunk == 1: decode and the chunk-1 forward) -- one CTA per row
//         keeps the row's state in registers, each thread a float4 quad of
//         columns on eight state rows, and walks the tokens; reductions
//         over the state rows are warp shuffles.
//   split (1 < chunk <= 64) -- two launches: a CTA per (row, chunk) does
//         all of the chunk-local work in parallel (the intra-chunk output,
//         the chunk's state contribution dS and its decay), then
//         carry_kernel walks each row's chunks in order, carrying the state
//         and adding the inter-chunk term.
//   block (anything else: a dimension above 64 or not a multiple of 4, a
//         chunk above 64) -- the first port's kernel, one thread block per
//         row walking every chunk.
//
// Input types: the per-token tensors (WKV6's r, k, v, log w; SSD's x, B,
// C) are float32 or bfloat16 (scan_dtype), each kernel a template over
// that type T: loads convert to float32 (gld, gld4), the output is stored
// in T once (gst4); the state, u, log a and every workspace stay float32,
// and everything is computed in float32.  For bfloat16 the split route's
// first launch writes its chunk-local output to a float32 workspace that
// the carry reads, so the output is rounded once.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace scan {

constexpr int kMaxDim = 64;    // N, P, D of the step and split routes
constexpr int kMaxChunk = 64;  // chunk of the split route
enum Route { kBlock = 0, kStep = 1, kSplit = 2 };

inline bool fits(int dim) { return dim > 0 && dim <= kMaxDim && dim % 4 == 0; }
inline bool aligned(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }
__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }

// The dynamic shared memory a kernel may use, raised once per device to
// the largest size asked for (cudaFuncSetAttribute is a call into the CUDA
// runtime that a launch need not repeat).
struct SmemOptIn {
  static constexpr int kDevices = 16;
  int bytes[kDevices] = {};
  template <typename Kernel>
  cudaError_t ensure(Kernel kernel, size_t need) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && (int)need <= bytes[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err == cudaSuccess && dev < kDevices) bytes[dev] = (int)need;
    return err;
  }
};

__device__ inline void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ inline float at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

using bf16 = __nv_bfloat16;

// One element, and four consecutive ones (8-byte aligned for bfloat16),
// of an input tensor as float32; four outputs stored rounded to T.
__device__ inline float gld(const float* p) { return *p; }
__device__ inline float gld(const bf16* p) { return __bfloat162float(*p); }
__device__ inline float4 gld4(const float* p) { return ld4(p); }
__device__ inline float4 gld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ inline void gst(float* p, float v) { *p = v; }
__device__ inline void gst(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ inline void gst4(float* p, float4 v) { st4(p, v); }
__device__ inline void gst4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage rows [0, rows) of a row-major (rows x cols) global matrix with row
// stride gld into shared memory with row stride sld as float32: by 16-byte
// cp.async copies for float32 (cols a multiple of 4, both starts 16-byte
// aligned), by converting loads for bfloat16; rows [rows, rows_pad) are
// zeroed.  The caller commits and waits.
template <typename T>
__device__ inline void stage_rows(float* dst, int sld, const T* src, long gld, int rows,
                                  int rows_pad, int cols) {
  const int quads = cols >> 2;
  for (int e = threadIdx.x; e < rows_pad * quads; e += blockDim.x) {
    const int i = e / quads, q = 4 * (e - i * quads);
    if (i >= rows)
      st4(dst + i * sld + q, make_float4(0.f, 0.f, 0.f, 0.f));
    else if constexpr (sizeof(T) == 4)
      cp_async16(dst + i * sld + q, src + i * gld + q);
    else
      st4(dst + i * sld + q, gld4(src + i * gld + q));
  }
}

// ---------------------------------------------------------------------------
// The split route's second launch.  One CTA per (row, slice of kCarryCols
// state columns) walks the row's chunks in order:
//   out[t, j] = post[t] * (sum_q lhs[t, q] S[q, j]) + out[t, j]
//   S[q, j]   = dec[q] * S[q, j] + dS[q, j]
// loc holds the chunk-local output from the first launch (out itself for
// float32 outputs); lhs is C (SSD, post = e^{Lcum}; of the input type) or
// r * e^{Lprev} (WKV, no post; float32); dec is the chunk's
// decay, e^{Llast} (a scalar for SSD, per state row for WKV).  lhs is
// staged by cp.async one chunk ahead; the state slice stays in shared
// memory; each thread owns a 4 x 4 tile of out (rows strided by 16, so the
// warp's four rows fall in distinct banks) and quads of S.  Sequential
// over the T / C chunks, parallel over rows and column slices; the
// products are float32 FMAs.
// ---------------------------------------------------------------------------
constexpr int kCarryCols = 32;
constexpr int kCarryThreads = 128;
constexpr int kCarryLds = kCarryCols + 4;
constexpr int kCarryQuads = kMaxDim * kCarryCols / 4 / kCarryThreads;  // state quads a thread

template <typename TL, typename TO>
struct CarryArgs {
  const TL* lhs;  // rows of row r, chunk c at lhs + ((r / lhs_share) * t + c * chunk) * k
  int lhs_share;
  const float* post;  // null, or post[r * t + c * chunk + i]
  const float* dec;   // dec[r * dec_row + c * dec_chunk + dec_off + q * dec_q]
  long dec_row;
  int dec_chunk, dec_off, dec_q;
  const float* ds;  // dS of (r, c): ds + ((long)r * nc + c) * k * p, (k x p)
  const float* s0;   // (rows, k, p)
  const float* loc;  // (rows, t, p): the chunk-local output
  TO* out;           // (rows, t, p)
  float* sout;       // (rows, k, p)
  int t, k, p, chunk;
};

inline size_t carry_smem_bytes(int k, int chunk) {
  return sizeof(float) * ((size_t)2 * up4(chunk) * (k + 4) + (size_t)k * kCarryLds);
}

// MinBlocks 1: registers as the compiler likes (135, three CTAs an SM);
// kCarryPacked: capped so that the five CTAs an SM that 44 KB of shared
// memory allows (K = C = 64) fit, with a few spills (launch_carry picks).
constexpr int kCarryPacked = 5;
template <int MinBlocks, typename TL, typename TO>
__global__ void __launch_bounds__(kCarryThreads, MinBlocks) carry_kernel(CarryArgs<TL, TO> a) {
  extern __shared__ float4 carry_smem[];
  const int k = a.k, ldk = k + 4, cp = up4(a.chunk), nc = a.t / a.chunk;
  float* lbuf[2] = {reinterpret_cast<float*>(carry_smem),
                    reinterpret_cast<float*>(carry_smem) + cp * ldk};
  float* S = lbuf[1] + cp * ldk;  // k x kCarryLds
  const long row = blockIdx.x;
  const int j0 = blockIdx.y * kCarryCols, ncols = min(kCarryCols, a.p - j0), nq = ncols >> 2;
  const int tid = threadIdx.x, ti = tid >> 3, tj = tid & 7, jq = 4 * tj;
  const bool col_on = jq < ncols;
  const TL* lhs_row = a.lhs + (row / a.lhs_share) * a.t * k;

  for (int e = tid; e < k * nq; e += kCarryThreads) {
    const int q = e / nq, jj = 4 * (e - q * nq);
    st4(S + q * kCarryLds + jj, ld4(a.s0 + (row * k + q) * a.p + j0 + jj));
  }
  stage_rows(lbuf[0], ldk, lhs_row, k, a.chunk, cp, k);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * a.chunk;
    if (c + 1 < nc) stage_rows(lbuf[(c + 1) & 1], ldk, lhs_row + (long)(c0 + a.chunk) * k, k,
                               a.chunk, cp, k);
    cp_async_commit();
    // this chunk's local outputs, dS and the decay, loaded while lhs lands
    const long orow = (row * a.t + c0 + ti) * a.p + j0 + jq;
    float4 loc[4], dsv[kCarryQuads];
    float dec[kCarryQuads];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      loc[i] = col_on && ti + 16 * i < a.chunk ? ld4(a.loc + orow + 16L * i * a.p)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* decp = a.dec + row * a.dec_row + (long)c * a.dec_chunk + a.dec_off;
    const float* ds = a.ds + (row * nc + c) * (long)k * a.p + j0;
#pragma unroll
    for (int i = 0; i < kCarryQuads; ++i) {
      const int e = tid + kCarryThreads * i, q = e / nq, jj = 4 * (e - q * nq);
      const bool on = e < k * nq;
      dsv[i] = on ? ld4(ds + (long)q * a.p + jj) : make_float4(0.f, 0.f, 0.f, 0.f);
      dec[i] = on ? decp[q * a.dec_q] : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();  // lhs of chunk c has landed; S holds the chunk's incoming state
    const float* L = lbuf[c & 1];
    float acc[4][4] = {};
    for (int q = 0; q < k; q += 4) {
      float4 lv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lv[i] = ld4(L + min(ti + 16 * i, cp - 1) * ldk + q);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float4 sv = ld4(S + (q + qq) * kCarryLds + jq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float l = at(lv[i], qq);
          acc[i][0] = fmaf(l, sv.x, acc[i][0]);
          acc[i][1] = fmaf(l, sv.y, acc[i][1]);
          acc[i][2] = fmaf(l, sv.z, acc[i][2]);
          acc[i][3] = fmaf(l, sv.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = ti + 16 * i;
      if (!col_on || tt >= a.chunk) continue;
      const float g = a.post ? a.post[row * a.t + c0 + tt] : 1.f;
      float4 o = loc[i];
      o.x = g * acc[i][0] + o.x;
      o.y = g * acc[i][1] + o.y;
      o.z = g * acc[i][2] + o.z;
      o.w = g * acc[i][3] + o.w;
      gst4(a.out + orow + 16L * i * a.p, o);
    }
    __syncthreads();  // every thread has read S
#pragma unroll
    for (int i = 0; i < kCarryQuads; ++i) {
      const int e = tid + kCarryThreads * i, q = e / nq, jj = 4 * (e - q * nq);
      if (e >= k * nq) continue;
      float4 s = ld4(S + q * kCarryLds + jj);
      s.x = dec[i] * s.x + dsv[i].x;
      s.y = dec[i] * s.y + dsv[i].y;
      s.z = dec[i] * s.z + dsv[i].z;
      s.w = dec[i] * s.w + dsv[i].w;
      st4(S + q * kCarryLds + jj, s);
    }
  }
  __syncthreads();
  for (int e = tid; e < k * nq; e += kCarryThreads) {
    const int q = e / nq, jj = 4 * (e - q * nq);
    st4(a.sout + (row * k + q) * a.p + j0 + jj, ld4(S + q * kCarryLds + jj));
  }
}

// The carry at full registers when all its CTAs fit on the card at once,
// else the packed copy: on the H100, WKV's 256 CTAs at RWKV6-1.6B's prefill
// run faster unpacked, SSD's 640 at Zamba2-2.7B's faster packed, in one
// wave instead of two (PERF.md §6).
template <typename TL, typename TO>
inline cudaError_t launch_carry(const CarryArgs<TL, TO>& a, int rows, cudaStream_t stream) {
  static SmemOptIn optin_free, optin_packed;
  const size_t smem = carry_smem_bytes(a.k, a.chunk);
  const dim3 grid(rows, (a.p + kCarryCols - 1) / kCarryCols);
  cudaError_t err = optin_free.ensure(carry_kernel<1, TL, TO>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, carry_kernel<1, TL, TO>,
                                                        kCarryThreads, smem);
  if (err != cudaSuccess) return err;
  if ((long)grid.x * grid.y <= (long)per_sm * sms) {
    carry_kernel<1, TL, TO><<<grid, kCarryThreads, smem, stream>>>(a);
  } else {
    err = optin_packed.ensure(carry_kernel<kCarryPacked, TL, TO>, smem);
    if (err != cudaSuccess) return err;
    carry_kernel<kCarryPacked, TL, TO><<<grid, kCarryThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace scan
