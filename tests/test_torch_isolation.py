"""The port stands alone: no JAX, nothing of the JAX package, the card by
default, and kernel wrappers that take the plain path only for CPU
tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import bcr, build
from repro_torch.kernels.btf import btf
from repro_torch.kernels.bts import bts
from repro_torch.kernels.flash_attn import check_card_operands, flash_attention
from repro_torch.kernels.fused_spike import fused_factor_spike
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv import wkv6

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"sap.py", "spike.py", "krylov.py", "btf.py", "bts.py", "fused_spike.py",
            "chip_smoke.py", "cyclic_reduction.py", "bcr.py", "sparse.py", "reorder.py",
            "operators.py", "convert.py", "api.py", "layers.py", "rwkv.py", "mamba.py",
            "engine.py", "ref.py", "wkv.py", "ssd.py", "rwkv6_1_6b.py", "zamba2_2_7b.py",
            "device.py", "transformer.py", "flash_attn.py", "stablelm_1_6b.py",
            "phi3_mini_3_8b.py", "minitron_8b.py", "starcoder2_15b.py", "batched.py",
            "solver_engine.py", "service.py", "metrics.py", "sap_solver.py", "trace.py",
            "cost.py", "roofline.py", "calibrate.py", "moe.py", "whisper.py",
            "deepseek_moe_16b.py", "mixtral_8x22b.py", "phi3_vision_4_2b.py",
            "whisper_medium.py", "autograd.py", "adamw.py", "compress.py", "pipeline.py",
            "checkpoint.py", "loop.py", "mesh.py", "distributed.py",
            "sequence_parallel.py", "sharding.py", "sharded.py", "tensor_parallel.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/models/convert.py", "src/repro_torch/serve/engine.py",
            "src/repro_torch/configs/__init__.py", "src/repro_torch/core/batched.py",
            "src/repro_torch/serve/solver_engine.py", "src/repro_torch/serve/service.py",
            "src/repro_torch/serve/metrics.py", "src/repro_torch/configs/sap_solver.py",
            "src/repro_torch/obs/__init__.py", "src/repro_torch/obs/trace.py",
            "src/repro_torch/obs/cost.py", "src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/roofline.py", "src/repro_torch/launch/calibrate.py",
            "src/repro_torch/models/moe.py", "src/repro_torch/models/whisper.py",
            "src/repro_torch/configs/deepseek_moe_16b.py",
            "src/repro_torch/configs/mixtral_8x22b.py",
            "src/repro_torch/configs/phi3_vision_4_2b.py",
            "src/repro_torch/configs/whisper_medium.py",
            "src/repro_torch/kernels/autograd.py", "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/compress.py", "src/repro_torch/data/pipeline.py",
            "src/repro_torch/train/checkpoint.py", "src/repro_torch/train/loop.py",
            "src/repro_torch/launch/mesh.py", "src/repro_torch/core/distributed.py",
            "src/repro_torch/models/sequence_parallel.py",
            "src/repro_torch/launch/sharding.py", "src/repro_torch/models/sharded.py",
            "src/repro_torch/models/tensor_parallel.py"} <= rel
    assert {f"src/repro_torch/examples/{name}.py" for name in (
        "__init__", "quickstart", "fleet_solve", "serve_async", "traced_solve",
        "distributed_solve", "serve_lm", "train_lm")} <= rel


def test_obs_and_launch_load_neither_jax_nor_the_reference_package():
    """Importing the observability slice in a fresh interpreter loads no
    module of jax or of ``repro``."""
    code = (
        "import sys, repro_torch.obs, repro_torch.obs.cost, repro_torch.launch, "
        "repro_torch.launch.calibrate, repro_torch.launch.sharding, repro_torch.models.sharded\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_plan_banded_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    band = T.random_banded(32, 2, 1.0, seed=0).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.plan_banded(band, T.SaPOptions(p=2))
    plan = T.plan_banded(band, T.SaPOptions(p=2), device="cpu")
    assert plan.band_pc.device.type == "cpu"


def _chain(p=2, m=3, k=4):
    g = torch.Generator().manual_seed(0)
    d = torch.randn(p, m, k, k, generator=g) + 4 * torch.eye(k)
    e = torch.randn(p, m, k, k, generator=g) * 0.3
    f = torch.randn(p, m, k, k, generator=g) * 0.3
    return d, e, f


def test_wrappers_on_cpu_tensors_use_the_plain_version_and_do_not_count(monkeypatch):
    def no_build(name):
        raise AssertionError(f"kernel {name} must not be built for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    wrappers = (btf, bts, fused_factor_spike, bcr.inv_odd, bcr.reduce, bcr.rhs_reduce, bcr.backsub,
                wkv6, ssd, flash_attention)
    before = [w.launches for w in wrappers]
    d, e, f = _chain()
    sinv, l = btf(d, e, f)
    ref = T.btf_ref(d, e, f)
    torch.testing.assert_close(sinv, ref.sinv, rtol=0, atol=0)
    b = torch.randn(2, 3, 4, 2)
    torch.testing.assert_close(bts(sinv, l, f, b), T.bts_ref(ref, b), rtol=0, atol=0)
    bq, cq = torch.randn(2, 4, 4), torch.randn(2, 4, 4)
    out = fused_factor_spike(d, e, f, bq, cq)
    assert len(out) == 6
    a_odd = bcr.inv_odd(d[0, :2], first=1)
    lo, hi, *_ = bcr.reduce(d[0, :2], e[0, :2], f[0, :2], a_odd)
    bb = torch.randn(2, 4, 3)
    x = bcr.backsub(a_odd, e[0, 1:2], f[0, 1:2], bb, bcr.rhs_reduce(lo, hi, bb))
    assert x.shape == bb.shape
    r, k, v = torch.randn(3, 4, 8, 4)
    o, s = wkv6(r, k, v, -torch.rand(4, 8, 4), torch.randn(4, 4), torch.zeros(4, 4, 4), chunk=4)
    assert o.shape == (4, 8, 4) and s.shape == (4, 4, 4)
    y, s = ssd(torch.randn(4, 8, 3), torch.randn(2, 8, 5), torch.randn(2, 8, 5), -torch.rand(4, 8),
               torch.zeros(4, 5, 3), chunk=8, hshare=2)
    assert y.shape == (4, 8, 3) and s.shape == (4, 5, 3)
    o = flash_attention(torch.randn(1, 4, 8, 8), torch.randn(1, 2, 8, 8), torch.randn(1, 2, 8, 8),
                        causal=True, window=4)
    assert o.shape == (1, 4, 8, 8)
    assert [w.launches for w in wrappers] == before


def test_wrappers_reject_bad_operands_before_launching(monkeypatch):
    """Checks that run before any kernel is built: dtype and shape."""
    from repro_torch.kernels import _launch

    d, e, f = _chain()
    solver = _launch.SOLVER_DTYPES  # float32, bfloat16, float64: float16 and mixed still refused
    with pytest.raises(TypeError, match="float32 or bfloat16 or float64"):
        _launch.check_operands("btf", d.device, solver, d=d.half(), e=e.half(), f=f.half())
    with pytest.raises(TypeError, match="one storage dtype"):
        _launch.check_operands("btf", d.device, solver, d=d.double(), e=e, f=f)
    with pytest.raises(ValueError, match="contiguous"):
        _launch.check_operands("btf", d.device, solver, d=d.transpose(-1, -2), e=e, f=f)
    with pytest.raises(ValueError, match="on"):
        _launch.check_operands("btf", torch.device("meta"), solver, d=d, e=e, f=f)
    with pytest.raises(ValueError, match="shape"):
        _launch.check_shape("btf", "e", e[:, :2], tuple(d.shape))
    q = torch.randn(1, 4, 8, 16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        check_card_operands(q.double(), q[:, :2].double(), q[:, :2].double())
    with pytest.raises(ValueError, match="contiguous"):
        check_card_operands(q.transpose(2, 3).contiguous().transpose(2, 3), q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="head dim"):
        check_card_operands(*(torch.zeros(1, h, 8, 12) for h in (4, 2, 2)))
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)  # contiguous, 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        check_card_operands(shifted, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="multiple of Hk"):
        flash_attention(q, q[:, :3], q[:, :3])


def test_kernel_sources_and_build_plan():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build._library_path(name).parent == build.BUILD_DIR
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # the build directory is ignored by git
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_grid_limits_are_refused_before_a_launch():
    """A fleet folded into a kernel's chain axis can outgrow a grid axis:
    the wrappers refuse it with the axis and its limit named."""
    from repro_torch.kernels import _launch

    _launch.check_grid("bcr reduce", "z", 65_535)
    _launch.check_grid("btf", "x", 2**31 - 1)
    with pytest.raises(ValueError, match="65,536 blocks on the grid's z axis exceed .* 65,535"):
        _launch.check_grid("bcr reduce", "z", 65_536)
    with pytest.raises(ValueError, match="y axis"):
        _launch.check_grid("bcr backsub", "y", 70_000)
    with pytest.raises(ValueError, match="x axis"):
        _launch.check_grid("bts", "x", 2**31)


def test_solver_configs_build_the_ports_objects():
    from repro_torch.configs import sap_solver
    from repro_torch.serve import AsyncSolverService, SolverEngine

    cfg = sap_solver.fleet()
    assert (cfg.n, cfg.k, cfg.tol, cfg.max_batch, cfg.fac_cache) == (16_384, 16, 1e-6, 64, 256)
    opts = cfg.to_sap_options(16)
    assert isinstance(opts, T.SaPOptions) and (opts.p, opts.variant) == (16, "C")
    eng = cfg.to_engine(16, device="cpu")
    assert isinstance(eng, SolverEngine) and (eng.max_batch, eng.cache_size) == (64, 256)
    svc = sap_solver.service().to_service(16, start=False, device="cpu")
    assert isinstance(svc, AsyncSolverService)
    assert (svc.queue_cap, svc.default_deadline_s, svc.max_batch) == (512, 30.0, 32)
    svc.close()
    assert set(sap_solver.SOLVER_SHAPES) == {"dense_200k", "dense_1m", "dense_4m"}
    assert (sap_solver.full().n, sap_solver.exact().variant, sap_solver.reduced().k) == (
        200_000, "E", 8)
