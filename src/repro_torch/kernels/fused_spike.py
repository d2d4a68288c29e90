"""Fused factor + spike-corner kernel (SaP-C/E factor stage).

Replaces the TPU kernel ``repro/kernels/fused_spike.py:_fused_kernel``
(``fused_factor_spike_pallas``).  The CUDA source is ``csrc/fused_spike.cu``:
one ascending pass over the M block rows carries four K x K blocks -- the
LU inverse, the UL inverse of the reversed chain (read through flipped
views, never copied), and the left and right spike right-hand sides -- and
writes the LU factors plus the four spike corners (v_bot, v_top, w_top,
w_bot).  The LU and UL recurrences never read each other, so each
partition runs them side by side.

Bound on the H100: operations (two inverses and six K x K products per
block row).  Each side of each partition runs on a thread-block cluster
whose CTAs own rows of its running inverse in shared memory and invert it
by panel Gauss-Jordan (``csrc/gj_cluster.cuh``); the spike carries, which
every CTA reads whole, stay in an L2-resident workspace.  The kernel's
``fused_cluster_size`` picks the cluster size from (P, K) -- 1 CTA a side
at P = 64, K = 200.  Blocks no cluster of 16 holds take the one-block
kernel; those launches are also counted apart, in
``fused_factor_spike.block_launches``.

Storage: float32, bfloat16 or float64, each on its own instantiation
(``fused_factor_spike.by_dtype`` counts them); bfloat16 computes in
float32, float64 in float64, and the workspace is of that compute dtype.
Float16, integer and mixed dtypes raise before any build.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.core.block_lu.fused_factor_spike_padded_ref`); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core.block_lu import DEFAULT_BOOST, compute_dtype, fused_factor_spike_padded_ref
from . import build
from ._launch import SOLVER_DTYPES, check_grid, check_operands, check_shape, entry, stream_handle


def fused_factor_spike(
    d: torch.Tensor,
    e: torch.Tensor,
    f: torch.Tensor,
    bq: torch.Tensor,
    cq: torch.Tensor,
    boost_eps: float = DEFAULT_BOOST,
) -> tuple[torch.Tensor, ...]:
    """Fused factor + spike corners for all partitions.

    d/e/f: (P, M, K, K); bq/cq: (P, K, K) per-partition couplings (see
    :func:`repro_torch.core.block_lu.pad_couplings`).  Returns
    ``(sinv, l, vb, vt, wt, wb)``: the LU factors (P, M, K, K) and the four
    spike corner blocks (P, K, K).
    """
    if d.device.type == "cpu":
        return fused_factor_spike_padded_ref(d, e, f, bq, cq, boost_eps)
    dtype = check_operands("fused_factor_spike", d.device, SOLVER_DTYPES, d=d, e=e, f=f, bq=bq,
                           cq=cq)
    p, m, k, _ = d.shape
    for name, t in (("d", d), ("e", e), ("f", f)):
        check_shape("fused_factor_spike", name, t, (p, m, k, k))
    for name, t in (("bq", bq), ("cq", cq)):
        check_shape("fused_factor_spike", name, t, (p, k, k))
    lib = build.load("fused_spike")
    cluster = entry(lib, "fused_cluster_size", dtype)(p, k)
    if cluster < 0:
        build.check(lib, -cluster, "fused_factor_spike cluster size")
    check_grid("fused_factor_spike", "x", p * max(cluster, 1))
    sinv = torch.empty_like(d)
    l = torch.empty_like(d)
    vb, vt, wt, wb = (torch.empty_like(bq) for _ in range(4))
    ws = torch.empty((p * entry(lib, "fused_workspace_floats", dtype)(k, cluster),),
                     dtype=compute_dtype(dtype), device=d.device)
    code = entry(lib, "fused_launch", dtype)(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), bq.data_ptr(), cq.data_ptr(),
        sinv.data_ptr(), l.data_ptr(), vb.data_ptr(), vt.data_ptr(), wt.data_ptr(),
        wb.data_ptr(), ws.data_ptr(), p, m, k, boost_eps, cluster, stream_handle(d.device),
    )
    build.check(lib, code, f"fused_factor_spike (cluster {cluster}, {dtype})")
    fused_factor_spike.launches += 1
    fused_factor_spike.by_dtype[dtype] = fused_factor_spike.by_dtype.get(dtype, 0) + 1
    if cluster == 0:
        fused_factor_spike.block_launches += 1
    return sinv, l, vb, vt, wt, wb


fused_factor_spike.launches = 0
fused_factor_spike.block_launches = 0  # those of them on the one-block kernel
fused_factor_spike.by_dtype = {}  # launches by storage dtype
