// Device building blocks shared by the block-tridiagonal kernels
// (btf.cu, bts.cu, fused_spike.cu): strided K x K matrix views, a
// block-cooperative matrix product, and the boosted Gauss-Jordan inverse.
//
// Every kernel runs one thread block per partition (a block-tridiagonal
// chain; two for the fused pass, one per LU / UL side); the block walks the
// chain's M block rows in a loop, which takes the place of the TPU
// kernels' sequential grid axis.  All arithmetic is
// float32 FMA on the CUDA cores: no tensor cores, no TF32.  The scan
// kernels (wkv.cu, ssd.cu) include this header only for sap_error_string.
#pragma once

#include <cuda_runtime.h>

namespace sap {

constexpr int kThreads = 512;
constexpr int kRed = 64;  // floats of shared scratch for reductions / pivot

// Element (r, c) of a float matrix at p[r * rs + c * cs].  Negative strides
// read a block flipped on one or both axes without a copy.
struct Mat {
  float* p;
  long rs;
  long cs;
  __device__ float& at(int r, int c) const { return p[r * rs + c * cs]; }
};

__device__ inline Mat rowmajor(const float* p, int ld) {
  return Mat{const_cast<float*>(p), ld, 1};
}
// x[K-1-r, K-1-c] of a K x K row-major block (flip on both axes).
__device__ inline Mat flip2(const float* p, int k) {
  return Mat{const_cast<float*>(p) + (long)(k - 1) * k + (k - 1), -k, -1};
}
// x[rows-1-r, c] of a row-major block (flip the row axis).
__device__ inline Mat fliprows(const float* p, int rows, int ld) {
  return Mat{const_cast<float*>(p) + (long)(rows - 1) * ld, -ld, 1};
}
__device__ inline Mat none() { return Mat{nullptr, 0, 0}; }

// C = base + sign * (A @ B) with A (n x q), B (q x r), C and base (n x r);
// base.p == nullptr means zero.  sign is +1 or -1, so "base - A@B" and
// "-(A@B)" round exactly as the plain versions' expressions do, up to the
// order of the inner sum.  Each thread owns a 4 x 4 micro-tile whose rows
// and columns are strided by the tile counts, so a warp reads one row of B
// with consecutive addresses and broadcasts the A element.
__device__ void block_gemm(Mat C, Mat A, Mat B, Mat base, float sign, int n, int q, int r) {
  constexpr int TM = 4, TN = 4;
  const int nti = (n + TM - 1) / TM, ntj = (r + TN - 1) / TN;
  for (int t = threadIdx.x; t < nti * ntj; t += blockDim.x) {
    const int ti = t / ntj, tj = t % ntj;
    float acc[TM][TN];
    int ii[TM], jj[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      ii[a] = ti + a * nti;
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;
    }
#pragma unroll
    for (int b = 0; b < TN; ++b) jj[b] = tj + b * ntj;
    for (int s = 0; s < q; ++s) {
      float av[TM], bv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = ii[a] < n ? A.at(ii[a], s) : 0.f;
#pragma unroll
      for (int b = 0; b < TN; ++b) bv[b] = jj[b] < r ? B.at(s, jj[b]) : 0.f;
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b)
        if (ii[a] < n && jj[b] < r) {
          const float b0 = base.p ? base.at(ii[a], jj[b]) : 0.f;
          C.at(ii[a], jj[b]) = b0 + sign * acc[a][b];
        }
  }
}

// The same product for a narrow right-hand side (r <= RMAX <= kNarrow):
// each warp owns RW output rows at a time, its lanes read those rows of A
// with consecutive addresses (RW independent loads per step, the inner
// loop unrolled so several steps are in flight), and a shuffle tree sums
// the partial dots.  This is the shape of every preconditioner apply
// (r = 1, or the batch width of solve_many), which is bound by reading A.
constexpr int kNarrow = 8;
template <int RMAX, int RW>
__device__ void block_gemm_narrow(Mat C, Mat A, Mat B, Mat base, float sign, int n, int q, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i0 = warp * RW; i0 < n; i0 += nw * RW) {
    float acc[RW][RMAX];
#pragma unroll
    for (int a = 0; a < RW; ++a)
#pragma unroll
      for (int c = 0; c < RMAX; ++c) acc[a][c] = 0.f;
#pragma unroll 8
    for (int s = lane; s < q; s += 32) {
      float av[RW];
#pragma unroll
      for (int a = 0; a < RW; ++a) av[a] = i0 + a < n ? A.at(i0 + a, s) : 0.f;
#pragma unroll
      for (int c = 0; c < RMAX; ++c)
        if (c < r) {
          const float bv = B.at(s, c);
#pragma unroll
          for (int a = 0; a < RW; ++a) acc[a][c] = fmaf(av[a], bv, acc[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RW; ++a)
#pragma unroll
      for (int c = 0; c < RMAX; ++c) {
        if (c < r && i0 + a < n) {  // uniform across the warp
          float v = acc[a][c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) C.at(i0 + a, c) = (base.p ? base.at(i0 + a, c) : 0.f) + sign * v;
        }
      }
  }
}

__device__ inline void gemm(Mat C, Mat A, Mat B, Mat base, float sign, int n, int q, int r) {
  if (r == 1)
    block_gemm_narrow<1, 4>(C, A, B, base, sign, n, q, r);
  else if (r <= kNarrow)
    block_gemm_narrow<kNarrow, 2>(C, A, B, base, sign, n, q, r);
  else
    block_gemm(C, A, B, base, sign, n, q, r);
}

// dst = src for an n x r block (either may be a flipped view).
__device__ inline void block_copy(Mat dst, Mat src, int n, int r) {
  for (int e = threadIdx.x; e < n * r; e += blockDim.x) dst.at(e / r, e % r) = src.at(e / r, e % r);
}

// Block-wide max; every thread gets the result.  red: kRed floats.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// In-place inverse of the K x K row-major block W by Gauss-Jordan with
// pivot boosting: the kernels' form of block_lu.gj_inverse.
//
// The plain version eliminates the augmented [A | I] (K x 2K).  At step t
// the A half's columns 0..t-1 are unit vectors and the I half's columns
// t..K-1 are still unit vectors, so W stores only the live columns: the
// I half's for c < t and the A half's for c >= t.  That halves the
// footprint (160 KB at K = 200 fits one block's shared memory) and keeps
// the arithmetic op for op:
//   scale = max(max|A|, 1e-30), thr = boost_eps * scale;
//   a pivot below thr in magnitude becomes +-thr (+ for zero);
//   a structurally zero row -- in the augmented form A[t, 0..K-1] == 0,
//   here W[t, t..K-1] == 0 since A[t, c<t] is exactly zero at step t --
//   takes pivot 1;
//   row = W[t] / piv, with the entry of column t being the I half's 1/piv;
//   every other row subtracts col[i] * row, column t starting from 0.
// W may live in shared or global memory; rowbuf/colbuf hold K floats each
// and red kRed floats, all in shared memory.
__device__ void gj_inverse_inplace(float* W, int k, float boost_eps, float* rowbuf, float* colbuf,
                                   float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float mx = 0.f;
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) mx = fmaxf(mx, fabsf(W[e]));
  const float scale = fmaxf(block_max(mx, red), 1e-30f);
  const float thr = boost_eps * scale;
  for (int t = 0; t < k; ++t) {
    if (warp == 0) {
      bool nz = false;
      for (int c = t + lane; c < k; c += 32) nz |= (W[(long)t * k + c] != 0.f);
      nz = __any_sync(0xffffffffu, nz);
      if (lane == 0) {
        float piv = W[(long)t * k + t];
        if (fabsf(piv) < thr) piv = piv >= 0.f ? thr : -thr;
        if (!nz) piv = 1.f;
        red[33] = piv;
      }
    }
    __syncthreads();
    const float piv = red[33];
    for (int c = threadIdx.x; c < k; c += blockDim.x) {
      rowbuf[c] = c == t ? 1.f / piv : W[(long)t * k + c] / piv;
      colbuf[c] = W[(long)c * k + t];
    }
    __syncthreads();
    for (int i = warp; i < k; i += nw) {
      float* wr = W + (long)i * k;
      if (i == t) {
        for (int c = lane; c < k; c += 32) wr[c] = rowbuf[c];
      } else {
        const float ci = colbuf[i];
        for (int c = lane; c < k; c += 32) wr[c] = (c == t ? 0.f : wr[c]) - ci * rowbuf[c];
      }
    }
    __syncthreads();
  }
}

// Shared memory for a kernel that inverts K x K blocks: kRed + 2K floats of
// scratch, plus the K x K elimination block W when it fits beside them.
// Returns the dynamic shared bytes; *w_in_smem says where W lives (else the
// caller gives every partition K*K floats of device workspace).
inline size_t gj_smem_bytes(int k, int* w_in_smem) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const size_t scratch = (size_t)(kRed + 2 * k) * sizeof(float);
  const size_t full = scratch + (size_t)k * k * sizeof(float);
  *w_in_smem = full <= (size_t)optin;
  return *w_in_smem ? full : scratch;
}

}  // namespace sap

extern "C" const char* sap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
