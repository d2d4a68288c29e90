// Block-tridiagonal LU factorization of P independent chains (SaP factor).
//
// Replaces the TPU kernel repro/kernels/btf.py:_btf_kernel (btf_pallas).
// Each chain walks its M block rows:
//   S_0 = D_0,  L_j = E_j inv(S_{j-1}),  S_j = D_j - L_j F_{j-1},
// inverting every S_j by boosted Gauss-Jordan.
//
// Bound: operations.  Per block row ~6 K^3 flops (inverse 2 K^3, two
// products 4 K^3) on 3 K^2 floats read and 2 K^2 written, ~K/2 flops per
// byte.  Design (btf_cluster_kernel): each chain runs on a thread-block
// cluster of cs CTAs, CTA r owning rows [r R, r R + R) of the running
// K x K block in its shared memory (gj_cluster.cuh).  Per block row:
//   1. L_j[rows] = E_j[rows] inv(S_{j-1}), the inverse read back from
//      sinv[j-1] (every CTA wrote its rows; L2 serves it);
//   2. S_j[rows] = D_j[rows] - L_j[rows] F_{j-1} into the slab (L_j read
//      back from l, which it was written to);
//   3. the panel Gauss-Jordan on the cluster; sinv[j] from the slabs.
// Both products stage their operands through shared memory in slices of
// 16 and keep an 8 x 4 tile a thread in registers: FMA on the CUDA cores
// in the compute type, no TF32.  The cluster size comes from the shape
// (btf_cluster_size): the smallest that holds the block, doubled while
// the P clusters still fit on the card at once -- 2 CTAs a chain at P = 64,
// K = 200, 16 for the single SaP-E reduced chain of 2K = 400.  Blocks that
// no cluster of 16 holds (K above ~720) take btf_kernel, one thread block
// a chain with the block in a device workspace that L2 serves.
//
// Storage types (common.cuh): float32, bfloat16 and float64, each with
// its own entry points (btf_launch, btf_launch_bf16, btf_launch_f64).
// bfloat16 computes in float32, float64 in float64.  For bfloat16 the
// carried values -- the last inverse that the next row multiplies and the
// row's multiplier L_j -- live in a float32 workspace (2 K^2 a chain) and
// sinv, l are stored rounded once; for float32 and float64 the outputs
// are the carried values.  A float64 slab is twice the bytes, so its
// cluster is larger (4 CTAs at K = 200, 16 at 2K = 400).
#include "gj_cluster.cuh"

using namespace sap;

namespace {

// Elements of C a one-block chain's workspace holds: the elimination
// block W unless it fits in shared memory, and, for a storage type other
// than C, the running multiplier L_j.
template <typename T>
__host__ __device__ inline long block_ws_elems(int k, int w_in_smem) {
  const long kk = (long)k * k;
  return (w_in_smem ? 0 : kk) + (std::is_same<T, Compute<T>>::value ? 0 : kk);
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads)
    btf_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ f, T* sinv,
               T* l, Compute<T>* ws, int m, int k, Compute<T> boost_eps, int w_in_smem) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* red = reinterpret_cast<C*>(smem_raw);
  C* rowbuf = red + kRed;
  C* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  C* slot = ws + blockIdx.x * block_ws_elems<T>(k, w_in_smem);
  C* W = w_in_smem ? colbuf + k : slot;
  C* lw = slot + (w_in_smem ? 0 : kk);  // L_j in C (T != C)
  const long base = (long)blockIdx.x * m * kk;

  block_copy<C>(rowmajor(W, k), rowmajor(d + base, k), k, k);
  for (long i = threadIdx.x; i < kk; i += blockDim.x) l[base + i] = conv<T>(C(0));
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  block_copy<C>(rowmajor(sinv + base, k), rowmajor(W, k), k, k);
  __syncthreads();

  for (int j = 1; j < m; ++j) {
    const long off = base + j * kk;
    C* lj = same ? reinterpret_cast<C*>(l + off) : lw;
    // L_j = E_j @ inv(S_{j-1}); the inverse is still in W
    block_gemm(rowmajor(lj, k), rowmajor(e + off, k), rowmajor(W, k), none<C>(), C(1), k, k, k);
    __syncthreads();
    // S_j = D_j - L_j @ F_{j-1}
    block_gemm(rowmajor(W, k), rowmajor(lj, k), rowmajor(f + off - kk, k), rowmajor(d + off, k),
               C(-1), k, k, k);
    if (!same) block_copy<C>(rowmajor(l + off, k), rowmajor(lj, k), k, k);
    __syncthreads();
    gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
    block_copy<C>(rowmajor(sinv + off, k), rowmajor(W, k), k, k);
    __syncthreads();
  }
}

// One chain per cluster of cs CTAs; grid (P cs), cluster (cs), kClusterThreads
// threads.  ws: 2 K^2 elements of C a chain when T != C (the last inverse,
// then the multiplier), else unused.
template <int NC, typename T>
__global__ void __launch_bounds__(kClusterThreads)
    btf_cluster_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ f,
                       T* sinv, T* l, Compute<T>* ws, int m, int k, Compute<T> boost_eps) {
  using C = Compute<T>;
  constexpr bool same = std::is_same<T, C>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab<C> s = make_slab(reinterpret_cast<C*>(smem_raw), k, cs, (int)cluster.block_rank(), true);
  const int n = s.nrows;
  const long kk = (long)k * k;
  const long chain = (long)(blockIdx.x / cs) * m * kk, mine = (long)s.row0 * k;
  C* inv_c = same ? nullptr : ws + (long)(blockIdx.x / cs) * 2 * kk;  // the last inverse
  C* l_c = same ? nullptr : inv_c + kk;                                // the multiplier

  // row 0: S_0 = D_0, l_0 = 0
  C mx = slab_load(s, rowmajor(d + chain + mine, k), n);
  for (long i = threadIdx.x; i < (long)n * k; i += kClusterThreads)
    l[chain + mine + i] = conv<T>(C(0));
  C scale = cluster_max(cluster, mx, s.red);
  gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));
  slab_store(s, rowmajor(sinv + chain + mine, k), n);
  if (!same) slab_store(s, rowmajor(inv_c + mine, k), n);

  for (int j = 1; j < m; ++j) {
    const long blk = chain + j * kk;
    C* lr = same ? reinterpret_cast<C*>(l + blk + mine) : l_c + mine;
    const C* inv_prev = same ? reinterpret_cast<const C*>(sinv + blk - kk) : inv_c;
    // 1. L_j = E_j inv(S_{j-1}), the inverse read back from device memory:
    // it goes by cp.async with the next slice in flight, where reads of the
    // peers' slabs over DSMEM block
    cluster.sync();  // every CTA's rows of inv(S_{j-1}) are in memory
    slab_product(s, rowmajor(lr, k), rowmajor(e + blk + mine, k), rowmajor(inv_prev, k),
                 none<C>(), C(1), n, k, k);
    __syncthreads();  // l_j's rows are written
    // 2. S_j = D_j - L_j F_{j-1}
    mx = slab_product(s, rowmajor(s.w, s.ld), rowmajor(lr, k), rowmajor(f + blk - kk, k),
                      rowmajor(d + blk + mine, k), C(-1), n, k, k);
    rows_out(l + blk + mine, lr, (long)n * k);
    // 3. inv(S_j)
    scale = cluster_max(cluster, mx, s.red);
    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmax(scale, C(1e-30)));
    slab_store(s, rowmajor(sinv + blk + mine, k), n);
    if (!same) slab_store(s, rowmajor(inv_c + mine, k), n);
  }
}

namespace {

template <typename T>
using BtfClusterKernel = void (*)(const T*, const T*, const T*, T*, T*, Compute<T>*, int, int,
                                  Compute<T>);

template <typename T>
BtfClusterKernel<T> cluster_kernel(int k) {
  return k > kClusterThreads ? btf_cluster_kernel<2, T> : btf_cluster_kernel<1, T>;
}

template <typename T>
int cluster_size_t(int p, int k) {
  if (k <= 0 || p <= 0) return -(int)cudaErrorInvalidValue;
  return cluster_size_for<Compute<T>>(cluster_kernel<T>(k), p, k);
}

template <typename T>
long workspace_elems_t(int k, int cluster) {
  if (cluster > 0) return std::is_same<T, Compute<T>>::value ? 0 : 2L * k * k;
  int w_in_smem = 0;
  gj_smem_bytes<Compute<T>>(k, &w_in_smem);
  return block_ws_elems<T>(k, w_in_smem);
}

template <typename T>
int launch_t(const T* d, const T* e, const T* f, T* sinv, T* l, Compute<T>* ws, int p, int m,
             int k, Compute<T> boost_eps, int cluster, void* stream) {
  using C = Compute<T>;
  if (p <= 0 || m <= 0 || k <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  if (workspace_elems_t<T>(k, cluster) > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    int w_in_smem = 0;
    const size_t smem = gj_smem_bytes<C>(k, &w_in_smem);
    cudaError_t err = cudaFuncSetAttribute(btf_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    btf_kernel<T><<<p, kThreads, smem, (cudaStream_t)stream>>>(d, e, f, sinv, l, ws, m, k,
                                                               boost_eps, w_in_smem);
    return (int)cudaGetLastError();
  }
  const size_t smem = slab_smem_bytes<C>(k, cluster, true);
  if (k > 2 * kClusterThreads || smem > (size_t)smem_optin()) return (int)cudaErrorInvalidValue;
  const BtfClusterKernel<T> kern = cluster_kernel<T>(k);
  const int active = max_active_clusters(kern, cluster, smem);
  if (active < 0) return -active;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(p * cluster), cluster, smem, (cudaStream_t)stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, d, e, f, sinv, l, ws, m, k, boost_eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// For each storage type (SAP_DTYPE_ENTRIES: btf_launch, btf_launch_bf16,
// btf_launch_f64, and the same suffixes on the other two):
//
// btf_cluster_size: the cluster size a btf launch of P chains of K x K
// blocks takes: 1..16, or 0 for the one-block kernel (blocks no cluster
// holds); a negative cudaError_t code on failure.
//
// btf_workspace_floats: elements of the compute type (float, or double for
// float64 storage) of device workspace each partition needs on the route
// of a cluster size (0: the one-block kernel, which needs K x K unless the
// elimination block fits in shared memory, and K x K more for bfloat16's
// multiplier; a cluster route needs 2 K x K for bfloat16, else none).
//
// btf_launch: cluster is the size btf_cluster_size gives, or (tests) any
// size 1..16 whose slab fits; 0 launches the one-block kernel.  A size the
// card cannot schedule is an error, never a fallback.
#define BTF_ENTRIES(T, SUF, C)                                                                 \
  extern "C" int btf_cluster_size##SUF(int p, int k) { return cluster_size_t<T>(p, k); }       \
  extern "C" long btf_workspace_floats##SUF(int k, int cluster) {                              \
    return workspace_elems_t<T>(k, cluster);                                                   \
  }                                                                                            \
  extern "C" int btf_launch##SUF(const T* d, const T* e, const T* f, T* sinv, T* l, C* ws,     \
                                 int p, int m, int k, C boost_eps, int cluster, void* stream) { \
    return launch_t<T>(d, e, f, sinv, l, ws, p, m, k, boost_eps, cluster, stream);             \
  }
SAP_DTYPE_ENTRIES(BTF_ENTRIES)
