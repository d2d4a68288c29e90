// Device building blocks shared by the block-tridiagonal kernels
// (btf.cu, bts.cu, fused_spike.cu, bcr.cu): storage and compute types,
// strided K x K matrix views, a block-cooperative matrix product, and the
// boosted Gauss-Jordan inverse.
//
// Every kernel runs one thread block per partition (a block-tridiagonal
// chain; two for the fused pass, one per LU / UL side); the block walks the
// chain's M block rows in a loop, which takes the place of the TPU
// kernels' sequential grid axis.
//
// Types.  A kernel is a template over its storage type T (float,
// __nv_bfloat16 or double) and computes in C = Compute<T>: float for
// float and bfloat16 storage, double for double -- the wider of T and
// float32, as block_lu.compute_dtype says for the plain versions.  A
// kernel reads T from device memory itself, converts on load, and stores
// each output once, rounded to T; everything it carries between rows,
// levels or chunks (running inverses, multipliers, sweep vectors,
// workspaces) stays in C.  The arithmetic is FMA on the CUDA cores in C:
// no tensor cores, no TF32.  The scan kernels (wkv.cu, ssd.cu) and the
// flash kernel include this header only for sap_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace sap {

constexpr int kThreads = 512;
constexpr int kRed = 64;  // elements of shared scratch for reductions / pivot

using bf16 = __nv_bfloat16;

template <typename T>
struct ComputeOf {
  using type = float;
};
template <>
struct ComputeOf<double> {
  using type = double;
};
template <typename T>
using Compute = typename ComputeOf<T>::type;

// D from S, rounding to nearest for a narrower D.
template <typename D, typename S>
__device__ __forceinline__ D conv(S x) {
  return static_cast<D>(x);
}
template <>
__device__ __forceinline__ float conv<float, bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ bf16 conv<bf16, float>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements of C as one shared-memory access: float4, or
// 32 bytes of double (two 16-byte accesses).
struct alignas(16) double4x {
  double x, y, z, w;
};
template <typename C>
struct Vec4Of {
  using type = float4;
};
template <>
struct Vec4Of<double> {
  using type = double4x;
};
template <typename C>
using V4 = typename Vec4Of<C>::type;
template <typename C>
__device__ __forceinline__ V4<C> v4(C a, C b, C c, C d) {
  return V4<C>{a, b, c, d};
}
template <typename C>
__device__ __forceinline__ V4<C> v4zero() {
  return V4<C>{C(0), C(0), C(0), C(0)};
}
template <typename C>
__device__ __forceinline__ V4<C>& as4(C* p) {
  return *reinterpret_cast<V4<C>*>(p);
}
template <typename C>
__device__ __forceinline__ const V4<C>& as4(const C* p) {
  return *reinterpret_cast<const V4<C>*>(p);
}

// Element (r, c) of a matrix of E at p[r * rs + c * cs].  Negative strides
// read a block flipped on one or both axes without a copy.  get() reads
// it converted to the compute type, put() stores a compute value rounded
// to E.
template <typename E>
struct Mat {
  E* p;
  long rs;
  long cs;
  __device__ E& at(int r, int c) const { return p[r * rs + c * cs]; }
  template <typename C>
  __device__ C get(int r, int c) const {
    return conv<C>(p[r * rs + c * cs]);
  }
  template <typename C>
  __device__ void put(int r, int c, C v) const {
    p[r * rs + c * cs] = conv<E>(v);
  }
};

template <typename E>
__device__ inline Mat<E> rowmajor(const E* p, int ld) {
  return Mat<E>{const_cast<E*>(p), ld, 1};
}
// x[K-1-r, K-1-c] of a K x K row-major block (flip on both axes).
template <typename E>
__device__ inline Mat<E> flip2(const E* p, int k) {
  return Mat<E>{const_cast<E*>(p) + (long)(k - 1) * k + (k - 1), -k, -1};
}
// x[rows-1-r, c] of a row-major block (flip the row axis).
template <typename E>
__device__ inline Mat<E> fliprows(const E* p, int rows, int ld) {
  return Mat<E>{const_cast<E*>(p) + (long)(rows - 1) * ld, -ld, 1};
}
template <typename E>
__device__ inline Mat<E> none() {
  return Mat<E>{nullptr, 0, 0};
}

// C = base + sign * (A @ B) with A (n x q), B (q x r), C and base (n x r),
// computed in Cd; base.p == nullptr means zero.  sign is +1 or -1, so
// "base - A@B" and "-(A@B)" round exactly as the plain versions'
// expressions do, up to the order of the inner sum.  Each thread owns a
// 4 x 4 micro-tile whose rows and columns are strided by the tile counts,
// so a warp reads one row of B with consecutive addresses and broadcasts
// the A element.
template <typename Cd, typename EO, typename EA, typename EB, typename EBase>
__device__ void block_gemm(Mat<EO> C, Mat<EA> A, Mat<EB> B, Mat<EBase> base, Cd sign, int n, int q,
                           int r) {
  constexpr int TM = 4, TN = 4;
  const int nti = (n + TM - 1) / TM, ntj = (r + TN - 1) / TN;
  for (int t = threadIdx.x; t < nti * ntj; t += blockDim.x) {
    const int ti = t / ntj, tj = t % ntj;
    Cd acc[TM][TN];
    int ii[TM], jj[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      ii[a] = ti + a * nti;
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = Cd(0);
    }
#pragma unroll
    for (int b = 0; b < TN; ++b) jj[b] = tj + b * ntj;
    for (int s = 0; s < q; ++s) {
      Cd av[TM], bv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = ii[a] < n ? A.template get<Cd>(ii[a], s) : Cd(0);
#pragma unroll
      for (int b = 0; b < TN; ++b) bv[b] = jj[b] < r ? B.template get<Cd>(s, jj[b]) : Cd(0);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = fma(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b)
        if (ii[a] < n && jj[b] < r) {
          const Cd b0 = base.p ? base.template get<Cd>(ii[a], jj[b]) : Cd(0);
          C.put(ii[a], jj[b], b0 + sign * acc[a][b]);
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
template <int RMAX, int RW, typename Cd, typename EO, typename EA, typename EB, typename EBase>
__device__ void block_gemm_narrow(Mat<EO> C, Mat<EA> A, Mat<EB> B, Mat<EBase> base, Cd sign, int n,
                                  int q, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i0 = warp * RW; i0 < n; i0 += nw * RW) {
    Cd acc[RW][RMAX];
#pragma unroll
    for (int a = 0; a < RW; ++a)
#pragma unroll
      for (int c = 0; c < RMAX; ++c) acc[a][c] = Cd(0);
#pragma unroll 8
    for (int s = lane; s < q; s += 32) {
      Cd av[RW];
#pragma unroll
      for (int a = 0; a < RW; ++a) av[a] = i0 + a < n ? A.template get<Cd>(i0 + a, s) : Cd(0);
#pragma unroll
      for (int c = 0; c < RMAX; ++c)
        if (c < r) {
          const Cd bv = B.template get<Cd>(s, c);
#pragma unroll
          for (int a = 0; a < RW; ++a) acc[a][c] = fma(av[a], bv, acc[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RW; ++a)
#pragma unroll
      for (int c = 0; c < RMAX; ++c) {
        if (c < r && i0 + a < n) {  // uniform across the warp
          Cd v = acc[a][c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0)
            C.put(i0 + a, c, (base.p ? base.template get<Cd>(i0 + a, c) : Cd(0)) + sign * v);
        }
      }
  }
}

template <typename Cd, typename EO, typename EA, typename EB, typename EBase>
__device__ inline void gemm(Mat<EO> C, Mat<EA> A, Mat<EB> B, Mat<EBase> base, Cd sign, int n, int q,
                            int r) {
  if (r == 1)
    block_gemm_narrow<1, 4>(C, A, B, base, sign, n, q, r);
  else if (r <= kNarrow)
    block_gemm_narrow<kNarrow, 2>(C, A, B, base, sign, n, q, r);
  else
    block_gemm(C, A, B, base, sign, n, q, r);
}

// dst = src for an n x r block (either may be a flipped view), converted
// through the compute type Cd.
template <typename Cd, typename ED, typename ES>
__device__ inline void block_copy(Mat<ED> dst, Mat<ES> src, int n, int r) {
  for (int e = threadIdx.x; e < n * r; e += blockDim.x)
    dst.put(e / r, e % r, src.template get<Cd>(e / r, e % r));
}

// Block-wide max; every thread gets the result.  red: kRed elements.
template <typename Cd>
__device__ Cd block_max(Cd v, Cd* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red[lane] : Cd(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// In-place inverse of the K x K row-major block W (compute type Cd) by
// Gauss-Jordan with pivot boosting: the kernels' form of
// block_lu.gj_inverse.
//
// The plain version eliminates the augmented [A | I] (K x 2K).  At step t
// the A half's columns 0..t-1 are unit vectors and the I half's columns
// t..K-1 are still unit vectors, so W stores only the live columns: the
// I half's for c < t and the A half's for c >= t.  That halves the
// footprint (160 KB at K = 200 in float fits one block's shared memory)
// and keeps the arithmetic op for op:
//   scale = max(max|A|, 1e-30), thr = boost_eps * scale;
//   a pivot below thr in magnitude becomes +-thr (+ for zero);
//   a structurally zero row -- in the augmented form A[t, 0..K-1] == 0,
//   here W[t, t..K-1] == 0 since A[t, c<t] is exactly zero at step t --
//   takes pivot 1;
//   row = W[t] / piv, with the entry of column t being the I half's 1/piv;
//   every other row subtracts col[i] * row, column t starting from 0.
// W may live in shared or global memory; rowbuf/colbuf hold K elements
// each and red kRed, all in shared memory.
template <typename Cd>
__device__ void gj_inverse_inplace(Cd* W, int k, Cd boost_eps, Cd* rowbuf, Cd* colbuf, Cd* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  Cd mx = Cd(0);
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) mx = fmax(mx, fabs(W[e]));
  const Cd scale = fmax(block_max(mx, red), Cd(1e-30));
  const Cd thr = boost_eps * scale;
  for (int t = 0; t < k; ++t) {
    if (warp == 0) {
      bool nz = false;
      for (int c = t + lane; c < k; c += 32) nz |= (W[(long)t * k + c] != Cd(0));
      nz = __any_sync(0xffffffffu, nz);
      if (lane == 0) {
        Cd piv = W[(long)t * k + t];
        if (fabs(piv) < thr) piv = piv >= Cd(0) ? thr : -thr;
        if (!nz) piv = Cd(1);
        red[33] = piv;
      }
    }
    __syncthreads();
    const Cd piv = red[33];
    for (int c = threadIdx.x; c < k; c += blockDim.x) {
      rowbuf[c] = c == t ? Cd(1) / piv : W[(long)t * k + c] / piv;
      colbuf[c] = W[(long)c * k + t];
    }
    __syncthreads();
    for (int i = warp; i < k; i += nw) {
      Cd* wr = W + (long)i * k;
      if (i == t) {
        for (int c = lane; c < k; c += 32) wr[c] = rowbuf[c];
      } else {
        const Cd ci = colbuf[i];
        for (int c = lane; c < k; c += 32) wr[c] = (c == t ? Cd(0) : wr[c]) - ci * rowbuf[c];
      }
    }
    __syncthreads();
  }
}

// Shared memory for a kernel that inverts K x K blocks of Cd: kRed + 2K
// elements of scratch, plus the K x K elimination block W when it fits
// beside them.  Returns the dynamic shared bytes; *w_in_smem says where W
// lives (else the caller gives every partition K*K elements of device
// workspace).
template <typename Cd>
inline size_t gj_smem_bytes(int k, int* w_in_smem) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const size_t scratch = (size_t)(kRed + 2 * k) * sizeof(Cd);
  const size_t full = scratch + (size_t)k * k * sizeof(Cd);
  *w_in_smem = full <= (size_t)optin;
  return *w_in_smem ? full : scratch;
}

}  // namespace sap

// One C entry point per storage type: MACRO(T, SUFFIX, C) defines NAME
// SUFFIX for T -- NAME for float32, NAME_bf16, NAME_f64 -- each calling
// the template instantiated at T; C is the compute type, which also
// carries the boost threshold (a double for float64 storage).
#define SAP_DTYPE_ENTRIES(MACRO) \
  MACRO(float, , float)          \
  MACRO(sap::bf16, _bf16, float) \
  MACRO(double, _f64, double)

extern "C" const char* sap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
