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
// 32 and keep an 8 x 4 tile a thread in registers: float32 FMA on the CUDA
// cores, no TF32.  The cluster size comes from the shape
// (btf_cluster_size): the smallest that holds the block, doubled while
// the P clusters still fit on the card at once -- 2 CTAs a chain at P = 64,
// K = 200, 16 for the single SaP-E reduced chain of 2K = 400.  Blocks that
// no cluster of 16 holds (K above ~720) take btf_kernel, one thread block
// a chain with the block in a device workspace that L2 serves.
#include "gj_cluster.cuh"

using namespace sap;

__global__ void __launch_bounds__(kThreads)
    btf_kernel(const float* __restrict__ d, const float* __restrict__ e,
               const float* __restrict__ f, float* sinv, float* l, float* ws, int m, int k,
               float boost_eps, int w_in_smem) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rowbuf = red + kRed;
  float* colbuf = rowbuf + k;
  const long kk = (long)k * k;
  float* W = w_in_smem ? colbuf + k : ws + blockIdx.x * kk;
  const long base = (long)blockIdx.x * m * kk;

  block_copy(rowmajor(W, k), rowmajor(d + base, k), k, k);
  for (long i = threadIdx.x; i < kk; i += blockDim.x) l[base + i] = 0.f;
  __syncthreads();
  gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
  block_copy(rowmajor(sinv + base, k), rowmajor(W, k), k, k);
  __syncthreads();

  for (int j = 1; j < m; ++j) {
    const long off = base + j * kk;
    // L_j = E_j @ inv(S_{j-1}); the inverse is still in W
    block_gemm(rowmajor(l + off, k), rowmajor(e + off, k), rowmajor(W, k), none(), 1.f, k, k, k);
    __syncthreads();
    // S_j = D_j - L_j @ F_{j-1}
    block_gemm(rowmajor(W, k), rowmajor(l + off, k), rowmajor(f + off - kk, k),
               rowmajor(d + off, k), -1.f, k, k, k);
    __syncthreads();
    gj_inverse_inplace(W, k, boost_eps, rowbuf, colbuf, red);
    block_copy(rowmajor(sinv + off, k), rowmajor(W, k), k, k);
    __syncthreads();
  }
}

// One chain per cluster of cs CTAs; grid (P cs), cluster (cs), kClusterThreads threads.
template <int NC>
__global__ void __launch_bounds__(kClusterThreads)
    btf_cluster_kernel(const float* __restrict__ d, const float* __restrict__ e,
                       const float* __restrict__ f, float* sinv, float* l, int m, int k,
                       float boost_eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  extern __shared__ __align__(16) float smem[];
  const Slab s = make_slab(smem, k, cs, (int)cluster.block_rank(), true);
  const int n = s.nrows;
  const long kk = (long)k * k;
  const long chain = (long)(blockIdx.x / cs) * m * kk, mine = (long)s.row0 * k;

  // row 0: S_0 = D_0, l_0 = 0
  float mx = slab_load(s, rowmajor(d + chain + mine, k), n);
  for (long i = threadIdx.x; i < (long)n * k; i += kClusterThreads) l[chain + mine + i] = 0.f;
  float scale = cluster_max(cluster, mx, s.red);
  gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmaxf(scale, 1e-30f));
  slab_store(s, rowmajor(sinv + chain + mine, k), n);

  for (int j = 1; j < m; ++j) {
    const long blk = chain + j * kk;
    // 1. L_j = E_j inv(S_{j-1}), the inverse read back from sinv: it goes by
    // cp.async with the next slice in flight, where reads of the peers'
    // slabs over DSMEM block (tools/kernel_phases.py measures both)
    cluster.sync();  // every CTA's rows of inv(S_{j-1}) are in sinv
    slab_product(s, rowmajor(l + blk + mine, k), rowmajor(e + blk + mine, k),
                 rowmajor(sinv + blk - kk, k), none(), 1.f, n, k, k);
    __syncthreads();  // l_j's rows are written
    // 2. S_j = D_j - L_j F_{j-1}
    mx = slab_product(s, rowmajor(s.w, s.ld), rowmajor(l + blk + mine, k), rowmajor(f + blk - kk, k),
                      rowmajor(d + blk + mine, k), -1.f, n, k, k);
    // 3. inv(S_j)
    scale = cluster_max(cluster, mx, s.red);
    gj_cluster_inverse_apart<NC>(cluster, s, boost_eps * fmaxf(scale, 1e-30f));
    slab_store(s, rowmajor(sinv + blk + mine, k), n);
  }
}

namespace {

using BtfClusterKernel = void (*)(const float*, const float*, const float*, float*, float*, int,
                                  int, float);

BtfClusterKernel cluster_kernel(int k) {
  return k > kClusterThreads ? btf_cluster_kernel<2> : btf_cluster_kernel<1>;
}

}  // namespace

// The cluster size a btf launch of P chains of K x K blocks takes: 1..16,
// or 0 for the one-block kernel (blocks no cluster holds); a negative
// cudaError_t code on failure.
extern "C" int btf_cluster_size(int p, int k) {
  if (k <= 0 || p <= 0) return -(int)cudaErrorInvalidValue;
  return cluster_size_for(cluster_kernel(k), p, k);
}

// Floats of device workspace each partition needs on the route of a
// cluster size (0: the one-block kernel, which needs K x K floats unless
// the elimination block fits in shared memory).
extern "C" long btf_workspace_floats(int k, int cluster) {
  if (cluster > 0) return 0;
  int w_in_smem = 0;
  gj_smem_bytes(k, &w_in_smem);
  return w_in_smem ? 0 : (long)k * k;
}

// cluster: the size btf_cluster_size gives, or (tests) any size 1..16
// whose slab fits; 0 launches the one-block kernel.  A size the card
// cannot schedule is an error, never a fallback.
extern "C" int btf_launch(const float* d, const float* e, const float* f, float* sinv, float* l,
                          float* ws, int p, int m, int k, float boost_eps, int cluster,
                          void* stream) {
  if (p <= 0 || m <= 0 || k <= 0 || cluster < 0 || cluster > kClusterMax)
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    int w_in_smem = 0;
    const size_t smem = gj_smem_bytes(k, &w_in_smem);
    cudaError_t err =
        cudaFuncSetAttribute(btf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    btf_kernel<<<p, kThreads, smem, (cudaStream_t)stream>>>(d, e, f, sinv, l, ws, m, k, boost_eps,
                                                            w_in_smem);
    return (int)cudaGetLastError();
  }
  const size_t smem = slab_smem_bytes(k, cluster, true);
  if (k > 2 * kClusterThreads || smem > (size_t)smem_optin()) return (int)cudaErrorInvalidValue;
  const BtfClusterKernel kern = cluster_kernel(k);
  const int active = max_active_clusters(kern, cluster, smem);
  if (active < 0) return -active;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3(p * cluster), cluster, smem, (cudaStream_t)stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, d, e, f, sinv, l, m, k, boost_eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
