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
//
// No exponential of this kernel has a positive argument, however strong
// the decay.  The intra weights are the one place an exponential is split:
// with the chunk cut into sub-chunks of 16 and ref the last row of s's
// sub-chunk J, a pair with t in a later sub-chunk (so s <= ref <= t - 1)
// takes e^{Lprev_t - Lcum_s} = e^{Lprev_t - Lcum_ref} * e^{Lcum_ref - Lcum_s},
// both factors <= 1.  A factor underflows only where the exact weight is
// already below float32's range.  Pairs within one sub-chunk keep the
// exact per-channel exponential.
//
// Three routes (scan.cuh), chosen by the wrapper from the shape:
//   step  (chunk 1) wkv_step_kernel: S' = diag(e^{log w}) S + k v^T and
//         o = r S + (r . (u k)) v, one pass over the state in registers;
//   split (chunk <= 64) wkv_chunk_kernel, a CTA per (row, chunk): Lcum by
//         a four-segment scan per channel, the intra weights (factored off
//         the diagonal sub-blocks: 16 x D x 16 products), o_intra = G v +
//         bonus v, the chunk's dS = (k * e^{Llast - Lcum})^T v, r *
//         e^{Lprev} and e^{Llast} for the carry; then scan::carry_kernel
//         adds (r * e^{Lprev}) @ S_c and carries S_c along the row;
//   block wkv_block_kernel: one thread block per row walks the chunks.
//
// Bound on the H100: at decode (C = 1) bytes -- the D x D state is read
// and written once per token; at prefill, bytes as well when counted in
// the token-by-token form (chip_smoke.py: wkv_work).  float32 arithmetic
// throughout, no tensor cores; r, k, v, log w and o are float32 or
// bfloat16 (the kernels' template T, scan.cuh), u, the state and the
// workspaces float32.  Entry points: wkv_launch (float32) and
// wkv_launch_bf16.
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

// The bonus r_t . (u k_t) of one token, summed in one order by both routes:
// lane q of each group of four sums the channel quads q, q + 4, ... and the
// four partial sums meet by two shuffles.  From a zero state a token's
// output is its bonus times v, so the two routes then give the same bits
// (RWKV6's first token is ill-conditioned at random weights, PERF.md L1).
template <typename T>
__device__ inline float bonus_sum(const T* r, const T* k, const float* u, int d, bool on) {
  const int part = threadIdx.x & 3;
  float acc = 0.f;
  if (on)
    for (int j = 4 * part; j < d; j += 16) {
      const float4 rv = gld4(r + j), kv = gld4(k + j), uv = ld4(u + j);
      acc = fmaf(rv.x * uv.x, kv.x, acc);
      acc = fmaf(rv.y * uv.y, kv.y, acc);
      acc = fmaf(rv.z * uv.z, kv.z, acc);
      acc = fmaf(rv.w * uv.w, kv.w, acc);
    }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

// ---- step route: chunk 1, the state in registers ---------------------------
// A CTA per row, a warp per 16 state columns: lane (g = lane / 4, q = lane %
// 4) owns the column quad 16 w + 4 q on state rows g, g + 8, ..., g + 56.
// u is staged in shared memory for the bonus.
template <typename T>
__global__ void __launch_bounds__(128)
    wkv_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ logw, const float* __restrict__ u,
                    const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sout,
                    int t, int d) {
  const long row = blockIdx.x;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int j = 16 * (threadIdx.x >> 5) + 4 * (lane & 3);
  const bool on = j < d;
  __shared__ float4 us4[scan::kMaxDim / 4];
  float* us = reinterpret_cast<float*>(us4);
  for (int i = threadIdx.x; i < d; i += blockDim.x) us[i] = u[row * d + i];
  float4 s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = g + 8 * i;
    s[i] = on && q < d ? ld4(s0 + (row * d + q) * d + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  for (int tt = 0; tt < t; ++tt) {
    const long base = (row * t + tt) * d;
    float rv[8], kv[8], wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = g + 8 * i;
      rv[i] = q < d ? gld(r + base + q) : 0.f;
      kv[i] = q < d ? gld(k + base + q) : 0.f;
      wv[i] = q < d ? expf(gld(logw + base + q)) : 0.f;
    }
    const float bonus = bonus_sum(r + base, k + base, us, d, true);
    const float4 vq = on ? gld4(v + base + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc.x = fmaf(rv[i], s[i].x, acc.x);
      acc.y = fmaf(rv[i], s[i].y, acc.y);
      acc.z = fmaf(rv[i], s[i].z, acc.z);
      acc.w = fmaf(rv[i], s[i].w, acc.w);
    }
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
    }
    if (on && g == 0)
      gst4(o + base + j, make_float4(acc.x + bonus * vq.x, acc.y + bonus * vq.y,
                                     acc.z + bonus * vq.z, acc.w + bonus * vq.w));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i].x = wv[i] * s[i].x + kv[i] * vq.x;
      s[i].y = wv[i] * s[i].y + kv[i] * vq.y;
      s[i].z = wv[i] * s[i].z + kv[i] * vq.z;
      s[i].w = wv[i] * s[i].w + kv[i] * vq.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = g + 8 * i;
    if (on && q < d) st4(sout + (row * d + q) * d + j, s[i]);
  }
}

// ---- split route, first launch: the chunk-local work -----------------------
constexpr int kChunkThreads = 256;
constexpr int kSub = 16;  // sub-chunk of the factored intra weights

struct ChunkLayout {  // shared memory, in floats; row strides padded by 4
  int cp, ld, ldg;
  int rs, ks, ls, kt, us, bn, tot, total;
  __host__ __device__ ChunkLayout(int d, int chunk)
      : cp(up4(chunk)), ld(d + 4), ldg(up4(chunk) + 4) {
    rs = 0;                                // r, then G^T: cp x max(ld, ldg)
    ks = rs + cp * (ld > ldg ? ld : ldg);  // k, then k * e^{Llast - Lcum}
    ls = ks + cp * ld;                     // log w, then Lcum
    kt = ls + cp * ld;                     // k * e^{Lcum_ref - Lcum}, then v
    us = kt + cp * ld;                     // u
    bn = us + ld;                          // the bonus r_t . (u k_t)
    tot = bn + cp;                         // the scan's segment totals: 4 x 64
    total = tot + 4 * scan::kMaxDim;
  }
};

// grid (rows, T / chunk).  oloc: (rows, T, d), the chunk-local output
// (o itself for float32); ws_ds: (rows, T / chunk, d, d); ws_rh: (rows, T,
// d) = r * e^{Lprev}; ws_el: (rows, T / chunk, d) = e^{Llast}.
// three CTAs an SM: their shared memory allows it, the registers are capped to match
template <typename T>
__global__ void __launch_bounds__(kChunkThreads, 3)
    wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ logw, const float* __restrict__ u,
                     float* __restrict__ oloc, float* __restrict__ ws_ds,
                     float* __restrict__ ws_rh, float* __restrict__ ws_el, int t, int d,
                     int chunk) {
  extern __shared__ float4 chunk_smem[];
  float* sm = reinterpret_cast<float*>(chunk_smem);
  const ChunkLayout ly(d, chunk);
  const int cp = ly.cp, ld = ly.ld, ldg = ly.ldg, nc = t / chunk, dq = d >> 2;
  float *Rs = sm + ly.rs, *Ks = sm + ly.ks, *Ls = sm + ly.ls, *Kt = sm + ly.kt;
  float *Us = sm + ly.us, *Bn = sm + ly.bn, *Tot = sm + ly.tot;
  float *Gt = Rs, *Vs = Kt;  // once the weights are formed
  const int tid = threadIdx.x;
  const long row = blockIdx.x;
  const int ci = blockIdx.y, c0 = ci * chunk;
  const long seq = (row * t + c0) * d;

  scan::stage_rows(Rs, ld, r + seq, d, chunk, cp, d);
  scan::stage_rows(Ks, ld, k + seq, d, chunk, cp, d);
  scan::stage_rows(Ls, ld, logw + seq, d, chunk, cp, d);
  scan::cp_async_commit();
  for (int i = tid; i < d; i += kChunkThreads) Us[i] = u[row * d + i];
  float4 vreg[4];  // v waits in registers until its buffer is free
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + kChunkThreads * i, tt = e / dq;
    vreg[i] = tt < chunk ? gld4(v + seq + (long)tt * d + 4 * (e - tt * dq))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  scan::cp_async_wait<0>();
  __syncthreads();
  {  // Lcum: thread (seg, ch) scans rows [16 seg, 16 seg + 16) of channel ch
    const int seg = tid >> 6, ch = tid & 63;
    const bool on = ch < d;
    float run[16], acc = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int tt = 16 * seg + i;
      acc += on && tt < chunk ? Ls[tt * ld + ch] : 0.f;
      run[i] = acc;
    }
    Tot[seg * scan::kMaxDim + ch] = acc;
    __syncthreads();
    float off = 0.f;
    for (int s2 = 0; s2 < seg; ++s2) off += Tot[s2 * scan::kMaxDim + ch];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int tt = 16 * seg + i;
      if (on && tt < chunk) Ls[tt * ld + ch] = off + run[i];
    }
  }
  __syncthreads();
  const int nsub = (chunk + kSub - 1) / kSub, last0 = (nsub - 1) * kSub;
  for (int e = tid; e < chunk * dq; e += kChunkThreads) {
    const int tt = e / dq, j = 4 * (e - tt * dq);
    const float4 rv = ld4(Rs + tt * ld + j);
    const float4 lp = tt ? ld4(Ls + (tt - 1) * ld + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    st4(ws_rh + seq + (long)tt * d + j, make_float4(rv.x * expf(lp.x), rv.y * expf(lp.y),
                                                    rv.z * expf(lp.z), rv.w * expf(lp.w)));
    if (tt < last0) {  // k * e^{Lcum_ref - Lcum_s}, ref the sub-chunk's last row
      const int ref = (tt / kSub) * kSub + kSub - 1;
      const float4 kv = ld4(Ks + tt * ld + j), lr = ld4(Ls + ref * ld + j);
      const float4 lt = ld4(Ls + tt * ld + j);
      st4(Kt + tt * ld + j, make_float4(kv.x * expf(lr.x - lt.x), kv.y * expf(lr.y - lt.y),
                                        kv.z * expf(lr.z - lt.z), kv.w * expf(lr.w - lt.w)));
    }
  }
  for (int e = tid; e < d; e += kChunkThreads)
    ws_el[(row * nc + ci) * d + e] = expf(Ls[(chunk - 1) * ld + e]);
  {  // the bonus: four threads a row
    const int tt = tid >> 2;
    const float acc = bonus_sum(Rs + min(tt, cp - 1) * ld, Ks + min(tt, cp - 1) * ld, Us, d,
                                tt < chunk);
    if ((tid & 3) == 0 && tt < cp) Bn[tt] = acc;
  }
  __syncthreads();
  // The intra weights G[t][s], s < t, held in registers until G^T's buffer
  // is free.  Pairs within a sub-chunk: the exact per-channel exponentials,
  // a thread a pair (at most 2 x 120 a thread).
  const int mlast = chunk - last0;
  const int npairs = (nsub - 1) * (kSub * (kSub - 1) / 2) + mlast * (mlast - 1) / 2;
  float dg[2] = {0.f, 0.f};
  int dpos[2] = {-1, -1};
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int idx = tid + kChunkThreads * it;
    if (idx >= npairs) break;
    const int sub = idx / (kSub * (kSub - 1) / 2), kk = idx - sub * (kSub * (kSub - 1) / 2);
    int tl = (int)((1.f + sqrtf(1.f + 8.f * kk)) * 0.5f);
    while (tl * (tl - 1) / 2 > kk) --tl;
    while ((tl + 1) * tl / 2 <= kk) ++tl;
    const int tt = sub * kSub + tl, ss = sub * kSub + kk - tl * (tl - 1) / 2;
    float acc = 0.f;
    for (int j = 0; j < d; j += 4) {
      const float4 rv = ld4(Rs + tt * ld + j), kv = ld4(Ks + ss * ld + j);
      const float4 lp = ld4(Ls + (tt - 1) * ld + j), lsv = ld4(Ls + ss * ld + j);
      acc = fmaf(rv.x * kv.x, expf(lp.x - lsv.x), acc);
      acc = fmaf(rv.y * kv.y, expf(lp.y - lsv.y), acc);
      acc = fmaf(rv.z * kv.z, expf(lp.z - lsv.z), acc);
      acc = fmaf(rv.w * kv.w, expf(lp.w - lsv.w), acc);
    }
    dg[it] = acc;
    dpos[it] = ss * ldg + tt;
  }
  // Pairs across sub-chunks: thread (combo, half) forms row t of block (I, J)
  // over half the channels, (r_t * e^{Lprev_t - Lcum_ref}) . K~_s for the 16
  // s of J; the halves meet by one shuffle.  Combos run J-major.
  float og[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) og[s] = 0.f;
  int ot = -1, oj = 0;
  const int half = tid & 1;
  {
    int rem = tid >> 1, jb = 0;
    while (jb < nsub - 1 && rem >= chunk - kSub * (jb + 1)) {
      rem -= chunk - kSub * (jb + 1);
      ++jb;
    }
    if (jb < nsub - 1) {
      ot = kSub * (jb + 1) + rem;
      oj = jb;
      const int ref = kSub * jb + kSub - 1;
      for (int j = 4 * half; j < d; j += 8) {
        const float4 rv = ld4(Rs + ot * ld + j), lp = ld4(Ls + (ot - 1) * ld + j);
        const float4 lr = ld4(Ls + ref * ld + j);
        const float4 re = make_float4(rv.x * expf(lp.x - lr.x), rv.y * expf(lp.y - lr.y),
                                      rv.z * expf(lp.z - lr.z), rv.w * expf(lp.w - lr.w));
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          const float4 kv = ld4(Kt + (kSub * jb + s) * ld + j);
          og[s] = fmaf(re.x, kv.x, fmaf(re.y, kv.y, fmaf(re.z, kv.z, fmaf(re.w, kv.w, og[s]))));
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSub; ++s) og[s] += __shfl_xor_sync(0xffffffffu, og[s], 1);
  __syncthreads();  // r, K~ and the raw k are read: their buffers take G^T, v and k e^{...}
#pragma unroll
  for (int it = 0; it < 2; ++it)
    if (dpos[it] >= 0) Gt[dpos[it]] = dg[it];
  if (ot >= 0 && half == 0)
#pragma unroll
    for (int s = 0; s < kSub; ++s) Gt[(kSub * oj + s) * ldg + ot] = og[s];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + kChunkThreads * i, tt = e / dq;
    if (tt < cp) st4(Vs + tt * ld + 4 * (e - tt * dq), vreg[i]);
  }
  for (int e = tid; e < chunk * dq; e += kChunkThreads) {
    const int tt = e / dq, j = 4 * (e - tt * dq);
    const float4 kv = ld4(Ks + tt * ld + j), ll = ld4(Ls + (chunk - 1) * ld + j);
    const float4 lt = ld4(Ls + tt * ld + j);
    st4(Ks + tt * ld + j, make_float4(kv.x * expf(ll.x - lt.x), kv.y * expf(ll.y - lt.y),
                                      kv.z * expf(ll.z - lt.z), kv.w * expf(ll.w - lt.w)));
  }
  __syncthreads();
  if (tid < (cp >> 2) * dq) {  // o_intra: rows 4 ti .. 4 ti + 3, columns 4 jq ..
    const int ti = tid / dq, jq = 4 * (tid - ti * dq);
    float acc[4][4] = {};
    const int send = min(4 * ti + 3, chunk);
    for (int s = 0; s < send; ++s) {
      const float4 gv = ld4(Gt + s * ldg + 4 * ti);
      const float4 vv = ld4(Vs + s * ld + jq);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ga = s < 4 * ti + a ? at(gv, a) : 0.f;
        acc[a][0] = fmaf(ga, vv.x, acc[a][0]);
        acc[a][1] = fmaf(ga, vv.y, acc[a][1]);
        acc[a][2] = fmaf(ga, vv.z, acc[a][2]);
        acc[a][3] = fmaf(ga, vv.w, acc[a][3]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int tt = 4 * ti + a;
      if (tt < chunk) {
        const float b = Bn[tt];
        const float4 vt = ld4(Vs + tt * ld + jq);
        st4(oloc + seq + (long)tt * d + jq,
            make_float4(acc[a][0] + b * vt.x, acc[a][1] + b * vt.y, acc[a][2] + b * vt.z,
                        acc[a][3] + b * vt.w));
      }
    }
  }
  if (tid < dq * dq) {  // dS: rows 4 di .. 4 di + 3, columns 4 jq ..
    const int di = tid / dq, jq = 4 * (tid - di * dq);
    float acc[4][4] = {};
    for (int tt = 0; tt < chunk; ++tt) {
      const float4 kv = ld4(Ks + tt * ld + 4 * di);
      const float4 vv = ld4(Vs + tt * ld + jq);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ka = at(kv, a);
        acc[a][0] = fmaf(ka, vv.x, acc[a][0]);
        acc[a][1] = fmaf(ka, vv.y, acc[a][1]);
        acc[a][2] = fmaf(ka, vv.z, acc[a][2]);
        acc[a][3] = fmaf(ka, vv.w, acc[a][3]);
      }
    }
    float* ds = ws_ds + ((row * nc + ci) * d + 4 * di) * d + jq;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(ds + (long)a * d, make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
  }
}

// ---- block route: the first port's kernel ----------------------------------
// One thread block per (batch, head) row walks its chunks in order, the
// state in shared memory; each thread accumulates its G[t][s] over the
// channels in a register.  Chunk buffers use a row stride of D + 1 floats.
constexpr int kBlockThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    wkv_block_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ logw, const float* __restrict__ u,
                     const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sout,
                     int t, int d, int chunk) {
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
      R[tt * dp + dd] = gld(r + gi);
      K[tt * dp + dd] = gld(k + gi);
      V[tt * dp + dd] = gld(v + gi);
      L[tt * dp + dd] = gld(logw + gi);
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
      gst(o + seq + (long)(c0 + tt) * d + j, (inter + intra) + Bn[tt] * V[tt * dp + j]);
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

size_t wkv_block_smem_bytes(int d, int chunk) {
  return sizeof(float) * ((size_t)4 * chunk * (d + 1) + (size_t)d * d + (size_t)chunk * chunk +
                          d + chunk);
}

}  // namespace

namespace {

// Floats of device workspace the split route needs: dS per (row, chunk),
// r * e^{Lprev} per (row, token) and e^{Llast} per (row, chunk); for
// bfloat16 also the chunk-local output per (row, token).
template <typename T>
long workspace_floats_t(int bh, int t, int d, int chunk) {
  const long nc = t / chunk;
  const long loc = sizeof(T) == 4 ? 0 : (long)t * d;
  return (long)bh * (nc * d * d + (long)t * d + nc * d + loc);
}

template <typename T>
int launch_t(const T* r, const T* k, const T* v, const T* logw, const float* u, const float* s0,
             T* o, float* sout, float* ws, int bh, int t, int d, int chunk, int route,
             void* stream) {
  if (bh <= 0 || chunk <= 0 || t % chunk != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = scan::fits(d) && scan::aligned(r) && scan::aligned(k) && scan::aligned(v) &&
                   scan::aligned(logw) && scan::aligned(s0) && scan::aligned(o) &&
                   scan::aligned(sout);
  if (route == scan::kStep) {
    if (chunk != 1 || !vec) return (int)cudaErrorInvalidValue;
    wkv_step_kernel<T><<<bh, 32 * ((d + 15) / 16), 0, st>>>(r, k, v, logw, u, s0, o, sout, t, d);
    return (int)cudaGetLastError();
  }
  if (route == scan::kSplit) {
    if (chunk > scan::kMaxChunk || !vec || !scan::aligned(ws)) return (int)cudaErrorInvalidValue;
    static scan::SmemOptIn optin;
    const int nc = t / chunk;
    const size_t smem = sizeof(float) * (size_t)ChunkLayout(d, chunk).total;
    cudaError_t err = optin.ensure(wkv_chunk_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    float* ws_ds = ws;
    float* ws_rh = ws_ds + (long)bh * nc * d * d;
    float* ws_el = ws_rh + (long)bh * t * d;
    float* oloc = sizeof(T) == 4 ? reinterpret_cast<float*>(o) : ws_el + (long)bh * nc * d;
    wkv_chunk_kernel<T><<<dim3(bh, nc), kChunkThreads, smem, st>>>(r, k, v, logw, u, oloc, ws_ds,
                                                                   ws_rh, ws_el, t, d, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan::CarryArgs<float, T> a{ws_rh, 1, nullptr, ws_el, (long)nc * d, d, 0, 1, ws_ds, s0,
                                oloc, o, sout, t, d, d, chunk};
    return (int)scan::launch_carry(a, bh, st);
  }
  if (route != scan::kBlock) return (int)cudaErrorInvalidValue;
  static scan::SmemOptIn optin;
  const size_t smem = wkv_block_smem_bytes(d, chunk);
  const cudaError_t err = optin.ensure(wkv_block_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  wkv_block_kernel<T><<<bh, kBlockThreads, smem, st>>>(r, k, v, logw, u, s0, o, sout, t, d,
                                                       chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// For each input type (wkv_launch: float32, wkv_launch_bf16):
//
// wkv_workspace_floats: floats of device workspace the split route needs.
//
// wkv_launch: r, k, v, logw, o: (bh, t, d) of the input type; u: (bh, d);
// s0, sout: (bh, d, d), float32; ws: wkv_workspace_floats floats (split
// route; else unused); t a multiple of chunk; route a scan::Route the
// shape fits (the step and split routes also need 16-byte-aligned
// operands).  Returns a cudaError_t code.
#define WKV_ENTRIES(T, SUF)                                                                     \
  extern "C" long wkv_workspace_floats##SUF(int bh, int t, int d, int chunk) {                  \
    return workspace_floats_t<T>(bh, t, d, chunk);                                              \
  }                                                                                             \
  extern "C" int wkv_launch##SUF(const T* r, const T* k, const T* v, const T* logw,             \
                                 const float* u, const float* s0, T* o, float* sout, float* ws, \
                                 int bh, int t, int d, int chunk, int route, void* stream) {    \
    return launch_t<T>(r, k, v, logw, u, s0, o, sout, ws, bh, t, d, chunk, route, stream);      \
  }
WKV_ENTRIES(float, )
WKV_ENTRIES(bf16, _bf16)
