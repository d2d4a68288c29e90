"""Block-tridiagonal LU factorization kernel (SaP factor stage).

Replaces the TPU kernel ``repro/kernels/btf.py:_btf_kernel`` (``btf_pallas``).
The CUDA source is ``csrc/btf.cu``: each partition walks the M block rows,
``S_0 = D_0``, ``L_j = E_j inv(S_{j-1})``, ``S_j = D_j - L_j F_{j-1}``,
inverting each ``S_j`` by boosted Gauss-Jordan.

Bound on the H100: operations (~6 K^3 flops per block row against 5 K^2
floats moved).  Each partition runs on a thread-block cluster whose CTAs
own rows of the running block in shared memory and invert it by panel
Gauss-Jordan (``csrc/gj_cluster.cuh``); the kernel's ``btf_cluster_size``
picks the cluster size from (P, K) -- 2 CTAs a partition at P = 64,
K = 200; 16 for the SaP-E reduced chain of 2K = 400.  Blocks no cluster of
16 holds (K above ~720) take the one-block kernel, the block in device
memory; those launches are also counted apart, in ``btf.block_launches``.

Storage: float32, bfloat16 or float64 (``precond_dtype``), each on its own
instantiation of the kernel (``btf.by_dtype`` counts them); bfloat16
computes in float32 and keeps the carried inverse and multiplier in a
float32 workspace, float64 computes in float64 (a larger cluster: its
slab is twice the bytes).  Float16, integer and mixed dtypes raise before
any build.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.core.block_lu.btf_ref`); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core.block_lu import DEFAULT_BOOST, btf_ref, compute_dtype
from . import build
from ._launch import SOLVER_DTYPES, check_grid, check_operands, check_shape, entry, stream_handle


def btf(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor all partitions.  d/e/f: (P, M, K, K) -> (sinv, l) same shape."""
    if d.device.type == "cpu":
        fac = btf_ref(d, e, f, boost_eps)
        return fac.sinv, fac.l
    dtype = check_operands("btf", d.device, SOLVER_DTYPES, d=d, e=e, f=f)
    p, m, k, _ = d.shape
    for name, t in (("d", d), ("e", e), ("f", f)):
        check_shape("btf", name, t, (p, m, k, k))
    lib = build.load("btf")
    cluster = entry(lib, "btf_cluster_size", dtype)(p, k)
    if cluster < 0:
        build.check(lib, -cluster, "btf cluster size")
    check_grid("btf", "x", p * max(cluster, 1))
    sinv = torch.empty_like(d)
    l = torch.empty_like(d)
    ws = torch.empty((max(1, p * entry(lib, "btf_workspace_floats", dtype)(k, cluster)),),
                     dtype=compute_dtype(dtype), device=d.device)
    code = entry(lib, "btf_launch", dtype)(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), sinv.data_ptr(), l.data_ptr(),
        ws.data_ptr(), p, m, k, boost_eps, cluster, stream_handle(d.device),
    )
    build.check(lib, code, f"btf (cluster {cluster}, {dtype})")
    btf.launches += 1
    btf.by_dtype[dtype] = btf.by_dtype.get(dtype, 0) + 1
    if cluster == 0:
        btf.block_launches += 1
    return sinv, l


btf.launches = 0
btf.block_launches = 0  # those of them on the one-block kernel
btf.by_dtype = {}  # launches by storage dtype
