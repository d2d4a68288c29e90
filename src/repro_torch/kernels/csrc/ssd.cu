// Chunked Mamba-2 SSD recurrence (the SaP-scan along the sequence axis).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py:_ssd_kernel
// (ssd_pallas).  The recurrence h_t = e^{a_t} h_{t-1} + b_t x_t^T with a
// scalar decay per head and step; per chunk of C tokens, with Lcum the
// inclusive cumulative sum of a over the chunk:
//   G     = (C B^T) * e^{Lcum_t - Lcum_s}, masked to s <= t     (C x C)
//   y     = e^{Lcum} * (C @ S) + G @ X                         (C x P)
//   S_out = e^{Llast} S + (B * e^{Llast - Lcum})^T X           (N x P)
// Every exponent is <= 0.  B and C are shared by the heads of a token in
// Mamba-2 (Zamba2 broadcasts them): row i reads b and c row i / hshare, so
// the wrapper passes them once per batch row (hshare = H).
//
// Three routes (scan.cuh), chosen by the wrapper from the shape:
//   step  (chunk 1) ssd_step_kernel: S' = e^a S + b x^T, y = e^a C^T S +
//         (c . b) x, one pass over the state in registers per token;
//   split (chunk <= 64) ssd_chunk_kernel, a CTA per (group of heads,
//         chunk): C B^T once for the group (it does not depend on the
//         head), then per head the decayed weights, y_intra = G X and the
//         chunk's dS = (B * e^{Llast - Lcum})^T X, with e^{Lcum} kept for
//         the carry; then scan::carry_kernel adds e^{Lcum} * (C @ S_c) and
//         carries S_c = e^{Llast} S_{c-1} + dS_{c-1} along the row;
//   block ssd_block_kernel: one thread block per row walks the chunks.
// Products are float32 FMAs from shared memory into 4 x 4 register tiles,
// operands staged by 16-byte cp.async copies.
//
// Bound on the H100: at decode (C = 1) bytes -- the N x P state is read
// and written once per token; at prefill (C = 64) operations, ~4 C N P
// flops per chunk in the products.  float32 arithmetic throughout, no
// tensor cores; x, B, C and y are float32 or bfloat16 (the kernels'
// template T, scan.cuh), log a, the state and the workspaces float32.
// Entry points: ssd_launch (float32) and ssd_launch_bf16.
#include "scan.cuh"

namespace {

using scan::at;
using scan::bf16;
using scan::gld;
using scan::gld4;
using scan::gst;
using scan::gst4;
using scan::ld4;
using scan::st4;
using scan::up4;

// c . b over n, in the order of the split route's C B^T product: quads in
// turn, each as fma(x, fma(y, fma(z, fma(w, acc))))).  From a zero state a
// token's output is (c . b) x on both routes, so they give the same bits
// there (the first token of a forward and of a decode step agree exactly).
template <typename T>
__device__ inline float cb_dot(const T* c, const T* b, int n) {
  float acc = 0.f;
  for (int q = 0; q < n; q += 4) {
    const float4 cv = gld4(c + q), bv = gld4(b + q);
    acc = fmaf(cv.x, bv.x, fmaf(cv.y, bv.y, fmaf(cv.z, bv.z, fmaf(cv.w, bv.w, acc))));
  }
  return acc;
}

// ---- step route: chunk 1, the state in registers ---------------------------
// A CTA per row, a warp per 16 state columns: lane (g = lane / 4, q = lane %
// 4) owns the column quad 16 w + 4 q on state rows g, g + 8, ..., g + 56.
// All eight quads are loaded before any arithmetic; sums over N are
// shuffles across g.
template <typename T>
__global__ void __launch_bounds__(128)
    ssd_step_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                    const float* __restrict__ loga, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ sout, int t, int n, int p,
                    int hshare) {
  const long row = blockIdx.x, brow = row / hshare;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int j = 16 * (threadIdx.x >> 5) + 4 * (lane & 3);
  const bool on = j < p;
  float4 s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = g + 8 * i;
    s[i] = on && q < n ? ld4(s0 + (row * n + q) * p + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int tt = 0; tt < t; ++tt) {
    const T* bt = b + (brow * t + tt) * n;
    const T* ct = c + (brow * t + tt) * n;
    float bv[8], cv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = g + 8 * i;
      bv[i] = q < n ? gld(bt + q) : 0.f;
      cv[i] = q < n ? gld(ct + q) : 0.f;
    }
    const float cb = cb_dot(ct, bt, n);
    const float4 xv = on ? gld4(x + (row * t + tt) * p + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ea = expf(loga[row * t + tt]);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc.x = fmaf(cv[i], s[i].x, acc.x);
      acc.y = fmaf(cv[i], s[i].y, acc.y);
      acc.z = fmaf(cv[i], s[i].z, acc.z);
      acc.w = fmaf(cv[i], s[i].w, acc.w);
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (on && g == 0)
      gst4(y + (row * t + tt) * p + j,
           make_float4(ea * acc.x + cb * xv.x, ea * acc.y + cb * xv.y, ea * acc.z + cb * xv.z,
                       ea * acc.w + cb * xv.w));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i].x = ea * s[i].x + bv[i] * xv.x;
      s[i].y = ea * s[i].y + bv[i] * xv.y;
      s[i].z = ea * s[i].z + bv[i] * xv.z;
      s[i].w = ea * s[i].w + bv[i] * xv.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = g + 8 * i;
    if (on && q < n) st4(sout + (row * n + q) * p + j, s[i]);
  }
}

// ---- split route, first launch: the chunk-local work -----------------------
constexpr int kChunkThreads = 256;

// Inclusive prefix sums of v[0, n) (n <= 64) in place, by the calling warp:
// each lane adds its pair, then a shuffle scan over the lanes' pair sums.
__device__ inline void warp_cumsum64(float* v, int n) {
  const int lane = threadIdx.x & 31;
  const float a = 2 * lane < n ? v[2 * lane] : 0.f;
  const float b = 2 * lane + 1 < n ? v[2 * lane + 1] : 0.f;
  const float pair = a + b;
  float incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  __syncwarp();
  if (2 * lane < n) v[2 * lane] = excl + a;
  if (2 * lane + 1 < n) v[2 * lane + 1] = excl + pair;
}

struct ChunkLayout {  // shared memory, in floats; row strides padded by 4
  int cp, ldn, ldp, ldc;
  int bs, cs, cbt, xs, lc, w, total;
  __host__ __device__ ChunkLayout(int n, int p, int chunk)
      : cp(up4(chunk)), ldn(n + 4), ldp(p + 4), ldc(up4(chunk) + 4) {
    bs = 0;                                   // B: cp x ldn
    cs = bs + cp * ldn;                       // C, then the head's G^T: cp x max(ldn, ldc)
    cbt = cs + cp * (ldn > ldc ? ldn : ldc);  // (C B^T)^T: cp x ldc
    xs = cbt + cp * ldc;                      // X: cp x ldp
    lc = xs + cp * ldp;                       // Lcum: cp
    w = lc + cp;                              // e^{Llast - Lcum}: cp
    total = w + cp;
  }
};

// grid (rows / hg, T / chunk).  yloc: (rows, T, p), the chunk-local
// output (y itself for float32); ws_ds: (rows, T / chunk, n, p); ws_ea:
// (rows, T) = e^{Lcum} of each token within its chunk.
// three CTAs an SM: their shared memory allows it, the registers are capped to match
template <typename T>
__global__ void __launch_bounds__(kChunkThreads, 3)
    ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ loga, float* __restrict__ yloc,
                     float* __restrict__ ws_ds, float* __restrict__ ws_ea, int t, int n, int p,
                     int chunk, int hshare, int hg) {
  extern __shared__ float4 chunk_smem[];
  float* sm = reinterpret_cast<float*>(chunk_smem);
  const ChunkLayout ly(n, p, chunk);
  const int cp = ly.cp, nc = t / chunk;
  float *Bs = sm + ly.bs, *Cs = sm + ly.cs, *CBt = sm + ly.cbt, *Xs = sm + ly.xs;
  float *Lc = sm + ly.lc, *W = sm + ly.w;
  float* Gt = Cs;  // after C B^T is formed
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * hg, brow = row0 / hshare;
  const int ci = blockIdx.y, c0 = ci * chunk;

  // Each head's X and log a are loaded into registers a head ahead, and
  // stored into shared memory once the previous head is done with it.
  const int pq = p >> 2;
  float4 xnext[4];
  float lnext[2];
  auto load_head = [&](long row) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + kChunkThreads * i, tt = e / pq;
      xnext[i] = tt < chunk ? gld4(x + (row * t + c0 + tt) * p + 4 * (e - tt * pq))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = tid + 32 * i;
      lnext[i] = tid < 32 && tt < chunk ? loga[row * t + c0 + tt] : 0.f;
    }
  };
  scan::stage_rows(Bs, ly.ldn, b + (brow * t + c0) * n, n, chunk, cp, n);
  scan::stage_rows(Cs, ly.ldn, c + (brow * t + c0) * n, n, chunk, cp, n);
  scan::cp_async_commit();
  load_head(row0);
  scan::cp_async_wait<0>();
  __syncthreads();
  {  // (C B^T)^T: thread (ti, tj) forms rows t = ti + 16 u, columns s = tj + 16 v
    const int ti = tid >> 4, tj = tid & 15;
    float acc[4][4] = {};
    for (int q = 0; q < n; q += 4) {  // the order of cb_dot
      float4 cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = ld4(Cs + min(ti + 16 * u, cp - 1) * ly.ldn + q);
        bv[u] = ld4(Bs + min(tj + 16 * u, cp - 1) * ly.ldn + q);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[u][v] = fmaf(cv[u].x, bv[v].x,
                           fmaf(cv[u].y, bv[v].y,
                                fmaf(cv[u].z, bv[v].z, fmaf(cv[u].w, bv[v].w, acc[u][v]))));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (ti + 16 * u < cp && tj + 16 * v < cp)
          CBt[(tj + 16 * v) * ly.ldc + ti + 16 * u] = acc[u][v];
  }
  for (int h = 0; h < hg; ++h) {
    const long row = row0 + h;
    __syncthreads();  // C B^T is formed; the previous head is done with Xs, Gt, Lc, W
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + kChunkThreads * i, tt = e / pq;
      if (tt < cp) st4(Xs + tt * ly.ldp + 4 * (e - tt * pq), xnext[i]);
    }
    if (tid < 32) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tid + 32 * i < cp) Lc[tid + 32 * i] = lnext[i];
      __syncwarp();
      warp_cumsum64(Lc, chunk);
    }
    __syncthreads();
    if (h + 1 < hg) load_head(row + 1);
    const float llast = Lc[chunk - 1];
    for (int i = tid; i < cp; i += kChunkThreads) {
      W[i] = i < chunk ? expf(llast - Lc[i]) : 0.f;
      if (i < chunk) ws_ea[row * t + c0 + i] = expf(Lc[i]);
    }
    // G^T[s][t] = (C B^T)[t][s] * e^{Lcum_t - Lcum_s}, masked to s <= t < chunk
    for (int e = tid; e < cp * cp; e += kChunkThreads) {
      const int s = e / cp, tt = e - s * cp;
      Gt[s * ly.ldc + tt] =
          (s <= tt && tt < chunk) ? CBt[s * ly.ldc + tt] * expf(Lc[tt] - Lc[s]) : 0.f;
    }
    __syncthreads();
    if (tid < (cp >> 2) * pq) {  // y_intra: rows 4 ti .. 4 ti + 3, columns 4 pj ..
      const int ti = tid / pq, jq = 4 * (tid - ti * pq);
      float acc[4][4] = {};
      const int send = min(4 * ti + 4, chunk);
      for (int s = 0; s < send; ++s) {
        const float4 gv = ld4(Gt + s * ly.ldc + 4 * ti);
        const float4 xv = ld4(Xs + s * ly.ldp + jq);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float gu = at(gv, u);
          acc[u][0] = fmaf(gu, xv.x, acc[u][0]);
          acc[u][1] = fmaf(gu, xv.y, acc[u][1]);
          acc[u][2] = fmaf(gu, xv.z, acc[u][2]);
          acc[u][3] = fmaf(gu, xv.w, acc[u][3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * ti + u < chunk)
          st4(yloc + (row * t + c0 + 4 * ti + u) * p + jq,
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]));
    }
    if (tid < (n >> 2) * pq) {  // dS: rows 4 ni .. 4 ni + 3 of N, columns 4 pj ..
      const int ni = tid / pq, jq = 4 * (tid - ni * pq);
      float acc[4][4] = {};
      for (int s = 0; s < chunk; ++s) {
        const float4 bv = ld4(Bs + s * ly.ldn + 4 * ni);
        const float4 xv = ld4(Xs + s * ly.ldp + jq);
        const float ws = W[s];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float bu = at(bv, u) * ws;
          acc[u][0] = fmaf(bu, xv.x, acc[u][0]);
          acc[u][1] = fmaf(bu, xv.y, acc[u][1]);
          acc[u][2] = fmaf(bu, xv.z, acc[u][2]);
          acc[u][3] = fmaf(bu, xv.w, acc[u][3]);
        }
      }
      float* ds = ws_ds + ((row * nc + ci) * n + 4 * ni) * p + jq;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        st4(ds + (long)u * p, make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]));
    }
  }
}

// ---- block route: the first port's kernel ----------------------------------
// One thread block per (batch, head) row walks its chunks in order; the
// N x P state stays in shared memory throughout.  Chunk buffers use a row
// stride of width + 1 floats, so lanes walking s read distinct banks.
constexpr int kBlockThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    ssd_block_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ loga, const float* __restrict__ s0,
                     T* __restrict__ y, float* __restrict__ sout, int t, int n, int p, int chunk,
                     int hshare) {
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
      X[tt * pp + j] = gld(x + (row * t + c0 + tt) * p + j);
    }
    for (int i = tid; i < chunk * n; i += nt) {
      const int tt = i / n, j = i % n;
      const long gi = (brow * t + c0 + tt) * n + j;
      Bm[tt * np + j] = gld(b + gi);
      Cm[tt * np + j] = gld(c + gi);
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
      gst(y + (row * t + c0 + tt) * p + j, expf(Lc[tt]) * inter + intra);
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

size_t ssd_block_smem_bytes(int n, int p, int chunk) {
  return sizeof(float) * ((size_t)chunk * (p + 1) + (size_t)2 * chunk * (n + 1) +
                          (size_t)n * p + (size_t)chunk * chunk + chunk);
}

// Heads a split-route CTA forms C B^T for: the largest divisor of hshare,
// up to 8, that still leaves four CTAs an SM.
int ssd_head_group(int bh, int nc, int hshare) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int hg = 1;
  for (int d = 2; d <= 8 && d <= hshare; ++d)
    if (hshare % d == 0 && (long)(bh / d) * nc >= 4L * sms) hg = d;
  return hg;
}

}  // namespace

namespace {

// Floats of device workspace the split route needs: dS per (row, chunk) and
// e^{Lcum} per (row, token); for bfloat16 also the chunk-local output per
// (row, token).
template <typename T>
long workspace_floats_t(int bh, int t, int n, int p, int chunk) {
  const long loc = sizeof(T) == 4 ? 0 : (long)t * p;
  return (long)bh * ((long)(t / chunk) * n * p + t + loc);
}

template <typename T>
int launch_t(const T* x, const T* b, const T* c, const float* loga, const float* s0, T* y,
             float* sout, float* ws, int bh, int t, int n, int p, int chunk, int hshare, int route,
             void* stream) {
  if (bh <= 0 || chunk <= 0 || t % chunk != 0 || hshare <= 0 || bh % hshare != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = scan::fits(n) && scan::fits(p) && scan::aligned(x) && scan::aligned(b) &&
                   scan::aligned(c) && scan::aligned(s0) && scan::aligned(y) &&
                   scan::aligned(sout);
  if (route == scan::kStep) {
    if (chunk != 1 || !vec) return (int)cudaErrorInvalidValue;
    ssd_step_kernel<T><<<bh, 32 * ((p + 15) / 16), 0, st>>>(x, b, c, loga, s0, y, sout, t, n, p,
                                                             hshare);
    return (int)cudaGetLastError();
  }
  if (route == scan::kSplit) {
    if (chunk > scan::kMaxChunk || !vec || !scan::aligned(ws)) return (int)cudaErrorInvalidValue;
    static scan::SmemOptIn optin;
    const int nc = t / chunk, hg = ssd_head_group(bh, nc, hshare);
    const size_t smem = sizeof(float) * (size_t)ChunkLayout(n, p, chunk).total;
    cudaError_t err = optin.ensure(ssd_chunk_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    float* ws_ds = ws;
    float* ws_ea = ws + (long)bh * nc * n * p;
    float* yloc = sizeof(T) == 4 ? reinterpret_cast<float*>(y) : ws_ea + (long)bh * t;
    ssd_chunk_kernel<T><<<dim3(bh / hg, nc), kChunkThreads, smem, st>>>(
        x, b, c, loga, yloc, ws_ds, ws_ea, t, n, p, chunk, hshare, hg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan::CarryArgs<T, T> a{c, hshare, ws_ea, ws_ea, t, chunk, chunk - 1, 0, ws_ds, s0, yloc, y,
                            sout, t, n, p, chunk};
    return (int)scan::launch_carry(a, bh, st);
  }
  if (route != scan::kBlock) return (int)cudaErrorInvalidValue;
  static scan::SmemOptIn optin;
  const size_t smem = ssd_block_smem_bytes(n, p, chunk);
  const cudaError_t err = optin.ensure(ssd_block_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_block_kernel<T><<<bh, kBlockThreads, smem, st>>>(x, b, c, loga, s0, y, sout, t, n, p, chunk,
                                                       hshare);
  return (int)cudaGetLastError();
}

}  // namespace

// For each input type (ssd_launch: float32, ssd_launch_bf16):
//
// ssd_workspace_floats: floats of device workspace the split route needs.
//
// ssd_launch: x, y: (bh, t, p); b, c: (bh / hshare, t, n), all of the
// input type; loga: (bh, t); s0, sout: (bh, n, p), float32; ws:
// ssd_workspace_floats floats (split route; else unused); t a multiple of
// chunk, bh a multiple of hshare; route a scan::Route the shape fits (the
// step and split routes also need 16-byte-aligned operands).  Returns a
// cudaError_t code.
#define SSD_ENTRIES(T, SUF)                                                                      \
  extern "C" long ssd_workspace_floats##SUF(int bh, int t, int n, int p, int chunk) {            \
    return workspace_floats_t<T>(bh, t, n, p, chunk);                                            \
  }                                                                                              \
  extern "C" int ssd_launch##SUF(const T* x, const T* b, const T* c, const float* loga,          \
                                 const float* s0, T* y, float* sout, float* ws, int bh, int t,   \
                                 int n, int p, int chunk, int hshare, int route, void* stream) { \
    return launch_t<T>(x, b, c, loga, s0, y, sout, ws, bh, t, n, p, chunk, hshare, route,        \
                       stream);                                                                  \
  }
SSD_ENTRIES(float, )
SSD_ENTRIES(bf16, _bf16)

// The heads a split-route chunk CTA takes together (chip_smoke.py prints it).
extern "C" int ssd_split_head_group(int bh, int t, int chunk, int hshare) {
  return ssd_head_group(bh, t / chunk, hshare);
}
