"""Block-tridiagonal solve kernel (SaP preconditioner apply).

Replaces the TPU kernels ``repro/kernels/bts.py:_fwd_kernel`` and
``_bwd_kernel`` (``bts_pallas``).  The CUDA source is ``csrc/bts.cu``: the
forward sweep ``y_j = b_j - L_j y_{j-1}`` and then the backward sweep
``x_j = Sinv_j (y_j - F_j x_{j+1})`` from j = M-1 down, in one launch.

Bound on the H100: bytes.  Every apply reads sinv, l and f once (for R = 1
about half a flop per byte).  For R <= 8 each partition runs on a
thread-block cluster whose CTAs own rows of every block, stream them
through a ring of shared-memory stages ahead of the sweep (TMA bulk
copies when a block row is a multiple of 16 bytes, else element copies)
and exchange the running vector over DSMEM; the kernel's ``bts_cluster_size`` picks the cluster
size from (P, K, R) -- 1, doubled while the P clusters fit on the card at
once.  Wider R (whole spikes, R = K) and blocks above K = 1024 take the
one-block kernel, whose launches are also counted apart, in
``bts.block_launches``.

Storage: float32, bfloat16 or float64, each on its own instantiation
(``bts.by_dtype`` counts them).  The blocks stream in the storage dtype;
the sweep computes in float32 for bfloat16 (its y in a float32 workspace,
x rounded once) and in float64 for float64.  Float16, integer and mixed
dtypes raise before any build.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.core.block_lu.bts_ref`); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core.block_lu import BTFactors, bts_ref, compute_dtype
from . import build
from ._launch import SOLVER_DTYPES, check_grid, check_operands, check_shape, entry, stream_handle


def bts(
    sinv: torch.Tensor, l: torch.Tensor, f: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Solve D x = b for all partitions.

    sinv/l/f: (P, M, K, K);  b: (P, M, K, R)  ->  x: (P, M, K, R).
    """
    if b.device.type == "cpu":
        return bts_ref(BTFactors(sinv=sinv, l=l, f=f), b)
    dtype = check_operands("bts", b.device, SOLVER_DTYPES, sinv=sinv, l=l, f=f, b=b)
    p, m, k, r = b.shape
    for name, t in (("sinv", sinv), ("l", l), ("f", f)):
        check_shape("bts", name, t, (p, m, k, k))
    lib = build.load("bts")
    cluster = entry(lib, "bts_cluster_size", dtype)(p, k, r)
    if cluster < 0:
        build.check(lib, -cluster, "bts cluster size")
    check_grid("bts", "x", p * max(cluster, 1))
    x = torch.empty_like(b)
    ws = torch.empty((max(1, p * entry(lib, "bts_workspace_floats", dtype)(m, k, r, cluster)),),
                     dtype=compute_dtype(dtype), device=b.device)
    code = entry(lib, "bts_launch", dtype)(
        sinv.data_ptr(), l.data_ptr(), f.data_ptr(), b.data_ptr(), x.data_ptr(),
        ws.data_ptr(), p, m, k, r, cluster, stream_handle(b.device),
    )
    build.check(lib, code, f"bts (cluster {cluster}, {dtype})")
    bts.launches += 1
    bts.by_cluster[cluster] = bts.by_cluster.get(cluster, 0) + 1
    bts.by_dtype[dtype] = bts.by_dtype.get(dtype, 0) + 1
    if cluster == 0:
        bts.block_launches += 1
    return x


bts.launches = 0
bts.block_launches = 0  # those of them on the one-block kernel
bts.by_cluster = {}  # launches by cluster size (0: the one-block kernel)
bts.by_dtype = {}  # launches by storage dtype
