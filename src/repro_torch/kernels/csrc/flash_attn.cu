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
// Both kernels below run one thread block per (batch, query head, 64-row
// query tile); the TPU kernel's interleaved (B*Hk, nq*G*Bq, D) fold of the
// G query heads, which feeds its 128-row matrix unit, is not carried over.
// A block walks the key tiles of 64 that its masks leave (the TPU kernel's
// block skip: causal, k_start <= q_end; window, k_end >= q_start - (window
// - 1)), the longest causal rows first.  Scores are kept in base-2 units
// (scaled by log2(e) / sqrt(D)) and exp2 takes the place of exp.  Masked
// scores are the finite -1e30 of the TPU kernel, not -inf, so a row whose
// first visited tile is fully masked gets p = exp(0) = 1 there, and the
// first tile with a visible key wipes that out through corr = exp(-1e30 -
// m) = 0, exactly as the TPU kernel and the plain version do.  Keys and
// values past Tk are loaded as zeros; query rows past Tq are computed and
// not stored.  Output in the inputs' type (bfloat16 rounded to nearest
// even, as torch rounds).
//
// float32 inputs (flash_kernel, the consistency check's path): float32 FMA
// on the CUDA cores.  Each of the 256 threads owns 4 query rows (ty*4 + i)
// and, in the score tile, the 4 keys tx + 16 j; its rows' m, l and D-wide
// accumulator (the columns tx + 16 j) stay in registers, and the
// probabilities go through shared memory for P V.  q is scaled as it is
// loaded.
//
// bfloat16 inputs (flash_kernel_bf16, the prefill's path): the tensor
// cores, mma.sync m16n8k16 (bfloat16 in, float32 accumulation).  Bound on
// the H100: the tensor cores -- 4 D operations per visible (query, key)
// pair and query head at 989 TFLOP/s (at Minitron-8B's prefill, T = 4096,
// D = 128: 0.139 ms), beside one exponential a pair on the special-function
// units and q, k, v and o moved once.  Design:
//   * 4 warps, each owning 16 query rows.  Q stays in registers as mma A
//     fragments, loaded once by ldmatrix.
//   * S = Q K^T on the tensor cores.  Products of bfloat16 inputs are exact
//     in float32, so this is the TPU kernel's arithmetic up to summation
//     order; the float32 accumulators are then scaled by log2(e) / sqrt(D)
//     (q is not pre-scaled: in bfloat16 that would round q a second time).
//   * Masks only on tiles that cross the diagonal, the window's edge or Tk;
//     a row's max and sum are reduced over the quad of lanes that share
//     it in the m16n8 accumulator layout (shuffles 1 and 2).
//   * P V on the tensor cores with p in two bfloat16 terms, hi = bf16(p)
//     and lo = bf16(p - hi), two mma into one float32 accumulator: ~16 bits
//     of p, an error near 2^-17 of each term against the TPU kernel's
//     float32 p (one bfloat16 p, as SDPA rounds it, moves a term by up to
//     2^-9).  The S accumulators are the A fragments of P V in registers
//     (two adjacent n8 C tiles are one k16 A tile), so P never touches
//     shared memory.
//   * K and V tiles in bfloat16 in a two-stage ring in shared memory,
//     filled by cp.async (16 bytes a copy): tile j + 1 loads while tile j
//     is multiplied.  Q is staged in V's second stage before the loop, so
//     a block needs 68 KB at D = 128 and three blocks share an SM.  Rows
//     are padded by 16 bytes so that the 8 rows one ldmatrix phase reads
//     fall in distinct banks; V is read with ldmatrix.trans.  When D % 16
//     != 0 the k-dimension of q and k is zero-padded to a multiple of 16 in
//     shared memory.
#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per thread block
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- float32 -----------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: 4 query rows and 4 keys a thread
static_assert(kBQ == kBK, "load_tile loads 64-row tiles of q, k and v alike");
constexpr int kPld = kBQ + 4;  // row stride of the transposed probabilities

__device__ inline void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// dst[r * ld + c] = mul * src[(row0 + r) * d + c] for the 64 rows of a
// tile, zero for rows at or past nrows; 8 consecutive elements a thread
// (d is a multiple of 8, so every load is 32-byte aligned).
__device__ void load_tile(float* dst, int ld, const float* src, int row0, int nrows, int d,
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
template <int NJ>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq, int hk, int tq,
                 int tk, int d, int causal, int window, float qscale) {
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
    float* out = o + qoff + (long)qp * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) out[col] = acc[i][j] / denom;
    }
  }
}

size_t flash_smem_bytes(int d) {
  const int ld = d + 4;
  return sizeof(float) * ((size_t)kBQ * ld + (size_t)kBK * (ld > kPld ? ld : kPld) +
                          (size_t)kBK * d);
}

template <int NJ>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int hq, int hk,
               int tq, int tk, int d, int causal, int window, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBQ - 1) / kBQ, hq, b);
  const float qscale = kLog2e / sqrtf((float)d);
  flash_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hk, tq, tk, d, causal, window, qscale);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the tensor cores ---------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarpsBf = 4;  // each owns 16 query rows
constexpr int kThreadsBf = 32 * kWarpsBf;
static_assert(kWarpsBf * 16 == kBQ, "the warps cover the query tile");

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must still be a mapped address)
__device__ inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bfloat16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] is this lane's pair of matrix i (row lane / 4,
// columns 2 (lane % 4) and + 1)
__device__ inline void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// the same, each matrix transposed: r[i] holds rows 2 (lane % 4) and + 1
// of column lane / 4
__device__ inline void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16, bfloat16, row) b (16 x 8, bfloat16, col)
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t bf16x2_bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// (x0, x1) = hi + lo: hi = bf16(x) (x0 in the low half), lo = bf16(x - hi)
__device__ inline void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Start the copies of rows row0 .. row0 + 63 of src (nrows rows of d) into
// dst (row stride ld), and the same rows of src2 into dst2 unless it is
// null; rows at or past nrows are zero-filled.  Chunk i = tid + j
// kThreadsBf of a tile is row i / (d / 8), 16-byte chunk i % (d / 8): the
// first is divided out, the others stepped.
__device__ inline void tiles_async(bf16* dst, const bf16* src, bf16* dst2, const bf16* src2,
                                   int ld, int row0, int nrows, int d) {
  const int chunks = d >> 3, step_r = kThreadsBf / chunks, step_c = kThreadsBf % chunks;
  int r = threadIdx.x / chunks, c = threadIdx.x % chunks;
  while (r < kBK) {
    const bool valid = row0 + r < nrows;
    const long from = (long)(valid ? row0 + r : 0) * d + 8 * c;
    const int to = r * ld + 8 * c;
    cp_async16(smem_u32(dst + to), src + from, valid);
    if (dst2) cp_async16(smem_u32(dst2 + to), src2 + from, valid);
    r += step_r;
    c += step_c;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

// KD: k16 steps of Q K^T the shared tiles hold (D <= 16 KD; kd = ceil(D /
// 16) of them run), and 2 KD n8 tiles of output columns (nd = D / 8 run).
template <int KD>
__global__ void __launch_bounds__(kThreadsBf, 3)
    flash_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int hq, int hk, int tq,
                      int tk, int d, int causal, int window, float sscale) {
  constexpr int ld = 16 * KD + 8;  // row stride: 16 bytes of padding
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // 2 stages x kBK x ld
  bf16* Vs = Ks + 2 * kBK * ld;                  // 2 stages x kBK x ld
  bf16* Qs = Vs + kBK * ld;  // kBQ x ld: V's second stage, free until the first prefetch

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // the m16n8 layout: rows g, g + 8; columns 2 tg, + 1
  const int kd = (d + 15) >> 4, nd = d >> 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, bb = blockIdx.z;
  const int q_start = qt * kBQ;
  const int w_start = q_start + 16 * warp;  // this warp's first row
  const long qoff = ((long)bb * hq + h) * tq * d;
  const long kvoff = ((long)bb * hk + h / (hq / hk)) * tk * d;
  const bf16* kg = k + kvoff;
  const bf16* vg = v + kvoff;

  int kt_hi = (tk + kBK - 1) / kBK - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + kBQ - 1) / kBK);
  int kt_lo = 0;
  if (window > 0) {
    const int lo = q_start - (window - 1) - (kBK - 1);  // least k_start that runs
    if (lo > 0) kt_lo = (lo + kBK - 1) / kBK;
  }

  // zero the columns d .. 16 KD - 1 of every tile (cp.async never writes them)
  const int padc = (16 * KD - d) >> 3;
  for (int i = tid; i < 4 * kBK * padc; i += kThreadsBf) {
    const int r = i / padc, c = d + (i - r * padc) * 8;
    *reinterpret_cast<uint4*>(Ks + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses: the A tile (rows of this warp, x4 over
  // row halves then column halves), K as B (x4 over column halves then
  // key halves) and V as B, transposed (x4 over key halves then column
  // halves)
  const int a_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  // Q and the first tile; Q goes to registers before V's second stage is refilled
  uint32_t qf[KD][4];
  if (kt_lo <= kt_hi) {
    tiles_async(Qs, q + qoff, nullptr, nullptr, ld, q_start, tq, d);
    tiles_async(Ks, kg, Vs, vg, ld, kt_lo * kBK, tk, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(smem_u32(Qs + a_row * ld + 16 * kk + a_col), qf[kk]);
    __syncthreads();
  }

  for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
    const int stage = it & 1;
    if (kt < kt_hi) {  // the next tile into the other stage, read two tiles ago
      tiles_async(Ks + (stage ^ 1) * kBK * ld, kg, Vs + (stage ^ 1) * kBK * ld, vg, ld,
                  (kt + 1) * kBK, tk, d);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * kBK * ld;
    const bf16* Vt = Vs + stage * kBK * ld;
    const int k_start = kt * kBK;

    // S = Q K^T: 16 rows x 64 keys a warp, eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk < kd) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(smem_u32(Kt + (16 * np + k_row) * ld + 16 * kk + k_col), b);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    // scale; masks where the tile crosses Tk, the diagonal or the window's edge
    const bool masked = k_start + kBK > tk || (causal && k_start + kBK - 1 > w_start) ||
                        (window > 0 && w_start + 15 - k_start >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sscale;
        if (masked) {
          const int qp = w_start + g + (e >> 1) * 8, kp = k_start + 8 * n + 2 * tg + (e & 1);
          if (!(kp < tk && (!causal || qp >= kp) && (window <= 0 || qp - kp < window)))
            x = kNegInf;
        }
        s[n][e] = x;
      }

    // the online softmax of rows g (e < 2) and g + 8 (e >= 2)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i]);  // the new running maximum
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      corr[i] = exp2f(m[i] - mx[i]);
      l[i] = l[i] * corr[i] + rs[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P V: the S tiles 2 kk and 2 kk + 1 are the A fragment of key
    // step kk, split into hi and lo bfloat16 terms
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        if (2 * np < nd) {
          uint32_t b[4];
          ldsm_x4_trans(smem_u32(Vt + (16 * kk + v_row) * ld + 16 * np + v_col), b);
          const bool pair = 2 * np + 1 < nd;
          mma_bf16(acc[2 * np], ah, b[0], b[1]);
          if (pair) mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
          mma_bf16(acc[2 * np], al, b[0], b[1]);
          if (pair) mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = w_start + g + 8 * i;
    if (qp >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* out = o + qoff + (long)qp * d + 2 * tg;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
      if (n < nd)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
  }
}

template <int KD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int hq, int hk,
                int tq, int tk, int d, int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 4 * kBK * (16 * KD + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_bf16<KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBQ - 1) / kBQ, hq, b);
  const float sscale = kLog2e / sqrtf((float)d);
  flash_kernel_bf16<KD><<<grid, kThreadsBf, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), hq, hk, tq, tk, d, causal, window, sscale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (b, hq, tq, d); k, v: (b, hk, tk, d); contiguous, all bfloat16
// (bf16 != 0: the tensor-core kernel) or all float32.  window <= 0: no
// window.  Returns a cudaError_t code; cudaErrorInvalidValue for shapes the
// kernels do not take (d not a multiple of 8 in [8, 128], hq not a
// multiple of hk).
extern "C" int flash_launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                            int hk, int tq, int tk, int d, int causal, int window, int bf16,
                            void* stream) {
  if (b <= 0 || hq <= 0 || hk <= 0 || hq % hk != 0 || tq <= 0 || tk < 0 || d < 8 || d > 128 ||
      d % 8 != 0 || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (d <= 32) return launch_bf16<2>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
    if (d <= 64) return launch_bf16<4>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
    if (d <= 96) return launch_bf16<6>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
    return launch_bf16<8>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
  }
  if (d <= 32) return launch_f32<2>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
  if (d <= 64) return launch_f32<4>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
  if (d <= 96) return launch_f32<6>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
  return launch_f32<8>(q, k, v, o, b, hq, hk, tq, tk, d, causal, window, s);
}
