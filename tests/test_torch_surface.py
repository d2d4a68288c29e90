"""The port's public surface against the JAX package's, and parity of the
last library functions ported (``third_stage``, ``gj_solve``,
``SOLVER_ARCHS``, ``mesh_axes``, ``n_devices``).

The surface walk reads the sources with ``ast`` and imports neither
package: every public top-level name of each module of ``src/repro/`` (a
``def``, a ``class`` or an assigned name not starting with ``_``; in an
``__init__.py`` also the names it imports) is bound at the top level of
the port's module of the same path (``kernels/ssd_chunk.py`` and
``kernels/wkv_chunk.py`` are the port's ``kernels/ssd.py`` and
``kernels/wkv.py``), or stands in ``EXCLUDED`` with its reason: XLA and
JAX machinery that has no PyTorch meaning.  Each excluded name must still
exist in the JAX package and still be missing from the port, so the table
cannot go stale either way.

The parity tests import both packages inside each test.  ``third_stage``
is host numpy on both sides and deterministic: ``perm`` and ``k_i`` equal
exactly.  ``gj_solve`` in float32 on blocks randn(K, K) / sqrt(K) + 4 I (ROADMAP
B3: unscaled random blocks have condition numbers in the thousands), x
within 1e-5 of the JAX x relative to its largest value -- the same
Gauss-Jordan steps in float32, the eliminations' products summed in
another order.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
JAX_PKG, PORT_PKG = SRC / "repro", SRC / "repro_torch"
RENAMES = {"kernels/ssd_chunk.py": "kernels/ssd.py", "kernels/wkv_chunk.py": "kernels/wkv.py"}

_XLA = "XLA or JAX machinery with no PyTorch counterpart"
_PALLAS = "a Pallas entry point: the CUDA wrapper under the kernel's name takes its place"
_COST = "XLA compile and cost analysis: the port's stage costs come from kernels/ops.py's *_work"
_RNG = "JAX's RNG idiom: the port draws with layers.normal(generator, ...)"
# (module under src/repro, name or None for the whole module) -> reason
EXCLUDED = {
    ("compat.py", None): _XLA,
    ("kernels/pallas_compat.py", None): _XLA,
    ("launch/dryrun.py", None): _XLA,
    ("launch/hlo_stats.py", None): _XLA,
    ("kernels/btf.py", "btf_pallas"): _PALLAS,
    ("kernels/bts.py", "bts_pallas"): _PALLAS,
    ("kernels/fused_spike.py", "fused_factor_spike_pallas"): _PALLAS,
    ("kernels/bcr.py", "bcr_factor_pallas"): _PALLAS,
    ("kernels/bcr.py", "bcr_solve_pallas"): _PALLAS,
    ("kernels/flash_attn.py", "flash_attention_pallas"): _PALLAS,
    ("kernels/__init__.py", "flash_attention_pallas"): _PALLAS,
    ("kernels/ssd_chunk.py", "ssd_pallas"): _PALLAS,
    ("kernels/wkv_chunk.py", "wkv6_pallas"): _PALLAS,
    ("kernels/ops.py", "default_impl"): "the port dispatches by tensor device",
    ("kernels/__init__.py", "default_impl"): "the port dispatches by tensor device",
    **{(mod, name): _COST for mod in ("obs/cost.py", "obs/__init__.py")
       for name in ("cost_of", "cost_of_compiled", "CompileLog", "COMPILES",
                    "install_compile_listener", "timed_compile")},
    ("core/batched.py", "factor_stages_compiled"): "the AOT jit cache",
    ("launch/roofline.py", "collective_bytes"): "an HLO parse",
    ("launch/roofline.py", "PEAK_FLOPS"): "a TPU constant",
    ("launch/roofline.py", "HBM_BW"): "a TPU constant",
    ("launch/roofline.py", "ICI_BW"): "a TPU constant",
    ("models/layers.py", "dense_init"): _RNG,
    ("models/layers.py", "split_rngs"): _RNG,
    ("models/layers.py", "flash_attention"): "the port's is kernels/ops.py:flash_attention",
}


def _bindings(path: Path, public_only: bool) -> set[str]:
    """Top-level names bound in ``path``: defs, classes and assigned names,
    and imported names where ``public_only`` is false or the module is an
    ``__init__.py`` (a package's re-exports are its surface)."""
    out = set()
    with_imports = not public_only or path.name == "__init__.py"
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} if public_only else out


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_is_ported_or_excluded(module):
    port = PORT_PKG / RENAMES.get(module, module)
    if (module, None) in EXCLUDED:
        assert not port.exists(), f"{module} is ported: take it out of EXCLUDED"
        return
    assert port.exists(), f"{module} has no counterpart {port.relative_to(SRC)}"
    missing = _bindings(JAX_PKG / module, True) - _bindings(port, False)
    unexplained = sorted(n for n in missing if (module, n) not in EXCLUDED)
    assert not unexplained, f"{module}: not in the port and not excluded: {unexplained}"


@pytest.mark.parametrize("module,name", sorted(EXCLUDED, key=str))
def test_exclusions_are_current(module, name):
    jax_path = JAX_PKG / module
    assert jax_path.exists(), f"{module} is gone from the JAX package"
    if name is None:
        return
    assert name in _bindings(jax_path, True), f"{module}:{name} is gone from the JAX package"
    port = PORT_PKG / RENAMES.get(module, module)
    assert name not in _bindings(port, False), f"{module}:{name} is ported: take it out"


def test_exclusion_reasons_are_stated():
    assert all(isinstance(r, str) and r for r in EXCLUDED.values())


def _third_stage_input(n, p, seed):
    """tests/test_reorder.py:118-124's construction: a shuffled sparse
    matrix, Cuthill-McKee over the whole, stored as a band."""
    from repro.core import reorder as R
    from repro.core.sparse import random_sparse

    csr = random_sparse(n, d=1.0, shuffle=True, seed=seed)
    csr_r = R.permute_symmetric(csr, R.cuthill_mckee(R.symmetrize(csr)))
    k = max(R.half_bandwidth(csr_r), 1)
    return R.csr_to_band(csr_r, k), k, p, n // p


@pytest.mark.parametrize("n,p,seed", [(256, 4, 13), (2048, 8, 7)])
def test_third_stage_matches_jax(n, p, seed):
    from repro.core.reorder import third_stage as jax_third_stage
    from repro_torch.core.reorder import third_stage

    band, k, p, part = _third_stage_input(n, p, seed)
    perm, k_i = third_stage(band, k, p, part)
    jperm, jk_i = jax_third_stage(band, k, p, part)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(k_i, jk_i)
    assert perm.dtype == jperm.dtype and k_i.dtype == jk_i.dtype
    assert sorted(perm.tolist()) == list(range(n)) and np.all(k_i <= k)


def test_third_stage_rejects_a_band_that_is_not_p_partitions():
    from repro_torch.core.reorder import third_stage

    with pytest.raises(ValueError, match="p \\* part_size"):
        third_stage(np.zeros((10, 5)), 2, 3, 4)


@pytest.mark.parametrize("k,r", [(4, 1), (16, 3), (37, 8)])
def test_gj_solve_matches_jax(k, r):
    import jax.numpy as jnp
    import torch

    from repro.core.block_lu import gj_solve as jax_gj_solve
    from repro_torch.core.block_lu import gj_solve

    rng = np.random.default_rng(k)
    a = (rng.normal(size=(k, k)) / np.sqrt(k) + 4 * np.eye(k)).astype(np.float32)
    b = rng.normal(size=(k, r)).astype(np.float32)
    x = gj_solve(torch.from_numpy(a), torch.from_numpy(b))
    jx = np.asarray(jax_gj_solve(jnp.asarray(a), jnp.asarray(b)))
    assert x.dtype == torch.float32 and x.shape == (k, r)
    assert np.abs(x.numpy() - jx).max() <= 1e-5 * np.abs(jx).max()
    np.testing.assert_allclose(a.astype(np.float64) @ x.double().numpy(), b, atol=1e-4)


def test_gj_solve_computes_bfloat16_in_float32():
    import torch

    from repro_torch.core.block_lu import gj_inverse, gj_solve

    a = torch.eye(8) * 2 + torch.ones(8, 8) / 8
    b = torch.ones(8, 2)
    x = gj_solve(a.bfloat16(), b.bfloat16())
    assert x.dtype == torch.float32
    want = gj_inverse(a.bfloat16().float()) @ b
    torch.testing.assert_close(x, want)


def test_solver_archs_match_jax():
    from repro.configs import SOLVER_ARCHS as JAX_SOLVER_ARCHS
    from repro_torch.configs import SOLVER_ARCHS

    assert list(SOLVER_ARCHS) == list(JAX_SOLVER_ARCHS) == ["sap-solver"]
    for name in ("full", "reduced", "exact", "service", "fleet"):
        port, ref = getattr(SOLVER_ARCHS["sap-solver"], name)(), \
            getattr(JAX_SOLVER_ARCHS["sap-solver"], name)()
        assert (port.name, port.n, port.k, port.variant, port.tol) == \
            (ref.name, ref.n, ref.k, ref.variant, ref.tol)


def test_mesh_axes_and_n_devices_on_one_rank(tmp_path):
    import torch.distributed as dist

    from repro_torch.core.distributed import mesh_axes, n_devices
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh_axes(mesh) == ("data", "model")
        assert n_devices(mesh) == 1
        flat = make_test_mesh((1,), ("data",), device="cpu")
        assert (mesh_axes(flat), n_devices(flat)) == (("data",), 1)
    finally:
        dist.destroy_process_group()
