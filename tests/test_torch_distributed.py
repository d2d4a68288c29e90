"""The port's solver split over ranks (``repro_torch.core.distributed``)
against the JAX package's ``repro.core.distributed`` and against itself.

The ranks are four processes on the CPU in one gloo group, started once
for the module (``spawn_ranks``: spawn start, a file store in a fresh
temporary directory, a finite group timeout, a time limit on the
children); they run every case and the tests below assert on what they
returned.  Subgroups of one and two of those ranks give the W = 1 and
W = 2 runs.  The JAX package runs in this process on a one-device mesh
(``make_test_mesh((1,), ("data",))``, all partitions on it), at the same
partition count, while the ranks work.

Inputs are the JAX tests' ``random_banded(600, 6, d=1.0, seed=5)`` and
``oscillatory_banded(600, 6, d=0.5, seed=0)`` with b = A x*.  Tolerances:

- against the JAX package, float32 throughout: x within 1e-4 relative
  (the two solve the same system to tol 1e-6 through preconditioners
  built by different kernels' arithmetic -- the JAX code's btf + UL btf
  + whole-spike bts, the port's fused pass); iterations equal, or within
  1.0 where a reduction order moves a quarter-exit; the same resolved
  variant; d_factor within 1e-6 (float32 row sums taken in another order);
- one preconditioner apply to b alone (a converged x cannot show a broken
  cross-rank exchange; the apply does) against the JAX package's: within
  APPLY_LIMIT of its largest value, per system (the test says why the
  d = 0.5 system's limit is wider);
- W = 1, 2 and 4 at the same partition count: x within 1e-5 relative
  (the dot products are summed in another order), and the apply within
  1e-6 of its largest value on both systems (the apply sums nothing across
  ranks: on one rank every exchange stays in the process);
- float64 E (``tests/test_distributed.py:120``'s case) against the port's
  single-process SaP-E at the same P, at tol 1e-8: the same iterations
  within 2, both float64 true residuals <= 1e-10, and x within 1e-6 of it
  and of x*, the JAX package's own bounds (``tests/test_distributed.py:
  110-114``).
"""

import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core.banded import band_to_dense, oscillatory_banded, random_banded

N, K = 600, 6
TOL32 = 1e-6
SYSTEMS = {"random": ("random_banded", dict(d=1.0, seed=5)),
           "oscillatory": ("oscillatory_banded", dict(d=0.5, seed=0))}
# (system, variant, P_total) held against the JAX package
JAX_CASES = [("random", v, p) for p in (8, 16) for v in ("C", "D", "E", "auto")] + [
    ("oscillatory", v, 16) for v in ("E", "auto")]
# (variant, P_total) run on 1, 2 and 4 ranks: on the random system, and E
# on the oscillatory one, whose interface chain is strongly coupled
WORLD_CASES = [(v, p) for p in (8, 16) for v in ("C", "D", "E")]
COUPLED_CASES = [("E", 8), ("E", 16)]
# The apply against the JAX package's, as a share of its largest value.
# On the d = 0.5 system the float32 rounding of two exact reduced-chain
# solves is amplified by the chain (cond(A) = 874): the port's and the JAX
# package's applies differ by 3.7e-3 there, and each lies within 3e-3 of
# x* = A^-1 b, which the exact preconditioner gives in exact arithmetic
# (with the port's block arithmetic in float64 the two agree to 1.6e-11).
# On the d = 1 system they differ by at most 1.2e-7.
APPLY_LIMIT = {"random": 1e-6, "oscillatory": 1e-2}
# shift strides against 4 rows a rank: below, equal to, above (r != 0),
# and twice p_loc (r == 0)
SHIFTS = (1, 3, 4, 6, 8, 9)
P_LOC_SHIFT = 4


def _system(name):
    fn, kw = SYSTEMS[name]
    band = {"random_banded": random_banded, "oscillatory_banded": oscillatory_banded}[fn](N, K, **kw)
    a = band_to_dense(torch.tensor(band)).numpy()
    xstar = np.random.default_rng(0).normal(size=N)
    return band, xstar, a @ xstar


def _solve(mesh, system, variant, p_total, dtype=np.float32, tol=TOL32, maxiter=300):
    band, xstar, b = _system(system)
    band_t = band.astype(dtype)
    pdt = torch.float32 if dtype == np.float32 else torch.float64
    dsap = D.build_dist_sap(mesh, N, K, variant=variant, p_per_device=p_total // mesh.size,
                            precond_dtype=pdt, band=band_t)
    band_l, b_l, parts = dsap.shard_band(band_t, b.astype(dtype))
    res = D.solve_step_fn(dsap, tol=tol, maxiter=maxiter)(band_l, b_l, *parts.values())
    # one preconditioner apply to b alone: its cross-rank exchanges are what
    # the converged x cannot show
    rb = b_l.reshape(dsap.p_local, dsap.m, K, 1).to(pdt).contiguous()
    z = dsap.precond(dsap.factor(**parts), parts["b_next"], parts["c_prev"], rb)
    return {"x": D.gather_x(res.x, mesh, N).double().numpy(),
            "z": D.gather_x(z.reshape(-1), mesh, N).double().numpy(), "variant": dsap.variant,
            "d_factor": dsap.d_factor, "iterations": float(res.iterations),
            "converged": bool(res.converged), "resnorm": float(res.resnorm),
            "true_resnorm": float(res.true_resnorm)}


def _ranks_body():
    """Every case, on each of the four ranks; rank 0's results are kept."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    torch.set_num_threads(1)
    rank = dist.get_rank()
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"jax": {}, "world": {}, "coupled": {}, "shift": {}}
    for case in JAX_CASES:
        out["jax"][case] = _solve(mesh, *case)
    out["f64"] = _solve(mesh, "oscillatory", "E", 16, np.float64, tol=1e-8, maxiter=100)
    for case in WORLD_CASES:
        out["world"][(4,) + case] = _solve(mesh, "random", *case)
    for case in COUPLED_CASES:
        out["coupled"][(4,) + case] = _solve(mesh, "oscillatory", *case)
    for w in (1, 2):  # subgroups of the first w ranks; every rank creates both
        group = dist.new_group(list(range(w)))
        if rank < w:
            sub = make_test_mesh((w,), ("data",), group=group, device="cpu")
            for case in WORLD_CASES:
                out["world"][(w,) + case] = _solve(sub, "random", *case)
            for case in COUPLED_CASES:
                out["coupled"][(w,) + case] = _solve(sub, "oscillatory", *case)
    # the shift primitives on rows numbered globally (row j holds j + 1)
    rows = (torch.arange(P_LOC_SHIFT, dtype=torch.float64) + 1 + rank * P_LOC_SHIFT)[:, None]
    for s in SHIFTS:
        out["shift"][("dn", s)] = D._shift_dn_rows(rows, s, mesh)[:, 0].tolist()
        out["shift"][("up", s)] = D._shift_up_rows(rows, s, mesh)[:, 0].tolist()
    gathered = [None] * 4
    dist.all_gather_object(gathered, out["shift"])
    out["shift"] = gathered
    try:  # no device named: the card, or an error where there is none
        make_test_mesh((2, 2), ("data", "model"))
        out["no_device"] = "card"
    except RuntimeError as exc:
        out["no_device"] = str(exc)
    out["mesh"] = {"coords": mesh.coords(), "rank": mesh.rank,
                   "production": dict(make_production_mesh(device="cpu").shape),
                   "multi_pod": dict(make_production_mesh(multi_pod=True, device="cpu").shape),
                   "perm_model": mesh.axis_perm(("model",), [(0, 1)])}
    return out if rank == 0 else None


def _jax_reference():
    """The JAX package's distributed solver on a one-device mesh."""
    import jax
    import jax.numpy as jnp

    from repro.core.distributed import build_dist_sap, solve_step_fn
    from repro.launch.mesh import make_test_mesh

    mesh = make_test_mesh((1,), ("data",))
    out = {}
    for system, variant, p_total in JAX_CASES:
        band, xstar, b = _system(system)
        dsap = build_dist_sap(mesh, N, K, variant=variant, p_per_device=p_total, band=band)
        if variant == "auto":  # the resolved variant's solve, run just before
            out[(system, variant, p_total)] = {**out[(system, dsap.variant, p_total)],
                                               "d_factor": dsap.d_factor}
            continue
        band_p, b_p, parts = dsap.shard_band(band, b)
        step = solve_step_fn(dsap, tol=TOL32, maxiter=300)
        rb = b_p.reshape(p_total, dsap.m, K, 1).astype(jnp.float32)
        blocks = [parts[nm] for nm in ("d", "e", "f", "b_next", "c_prev")]
        with mesh:
            res = jax.jit(step)(band_p.astype(jnp.float32), b_p.astype(jnp.float32), *blocks)
            z = jax.jit(lambda *a: dsap.precond(dsap.factor(*a[:5]), a[3], a[4], a[5]))(
                *blocks, rb)
        out[(system, variant, p_total)] = {
            "x": np.asarray(res.x, np.float64)[:N],
            "z": np.asarray(z, np.float64).reshape(-1)[:N], "variant": dsap.variant,
            "d_factor": dsap.d_factor, "iterations": float(res.iterations)}
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import spawn_ranks

    got = {}

    def ranks():
        try:
            got["ranks"] = spawn_ranks(_ranks_body, 4, timeout=240)[0]
        except BaseException as exc:  # reported by the fixture below
            got["error"] = exc

    th = threading.Thread(target=ranks)
    th.start()
    try:
        jax_out = _jax_reference()
    finally:
        th.join()
    if "error" in got:
        raise got["error"]
    return {"ranks": got["ranks"], "jax": jax_out}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ranks_match_jax_one_device_mesh(runs, case):
    got, want = runs["ranks"]["jax"][case], runs["jax"][case]
    assert got["variant"] == want["variant"]
    if case[1] == "auto":
        assert abs(got["d_factor"] - want["d_factor"]) <= 1e-6, (got["d_factor"], want["d_factor"])
    assert abs(got["iterations"] - want["iterations"]) <= 1.0, (got["iterations"], want["iterations"])
    assert got["converged"] and got["resnorm"] <= TOL32
    assert _rel(got["x"], want["x"]) <= 1e-4


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "-".join(map(str, c)))
def test_preconditioner_apply_matches_jax_one_device_mesh(runs, case):
    got, want = runs["ranks"]["jax"][case]["z"], runs["jax"][case]["z"]
    assert np.abs(got - want).max() <= APPLY_LIMIT[case[0]] * np.abs(want).max()


@pytest.mark.parametrize("case", WORLD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("world", (1, 2))
def test_one_two_and_four_ranks_agree(runs, world, case):
    w = runs["ranks"]["world"]
    assert abs(w[(world,) + case]["iterations"] - w[(4,) + case]["iterations"]) <= 1.0
    assert _rel(w[(world,) + case]["x"], w[(4,) + case]["x"]) <= 1e-5


@pytest.mark.parametrize("case", [("world",) + c for c in WORLD_CASES]
                         + [("coupled",) + c for c in COUPLED_CASES],
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("world", (1, 2))
def test_preconditioner_apply_is_the_same_on_one_two_and_four_ranks(runs, world, case):
    kind, rest = case[0], case[1:]
    got, want = runs["ranks"][kind][(world,) + rest]["z"], runs["ranks"][kind][(4,) + rest]["z"]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_float64_exact_variant_matches_single_process(runs):
    """Mirrors ``tests/test_distributed.py:120``: SaP-E across ranks, by
    parallel cyclic reduction, against the single-process SaP-E (BCR on the
    interface chain) at P = 16 in float64, on the d = 0.5 system whose
    spikes do not decay."""
    from repro_torch.core import SaPOptions, factor, plan_banded

    band, xstar, b = _system("oscillatory")
    opts = SaPOptions(p=16, variant="E", tol=1e-8, maxiter=100, precond_dtype="float64")
    ref = factor(plan_banded(band, opts, device="cpu")).solve(torch.tensor(b))
    got = runs["ranks"]["f64"]
    assert got["variant"] == "E" and got["converged"] and got["resnorm"] <= 1e-8
    assert bool(ref.converged)
    assert abs(got["iterations"] - float(ref.iterations)) <= 2.0
    # float64 factors (the plain block kernels compute in the storage dtype)
    # take both float64 true residuals to ~1e-12, where their ratio is noise
    assert got["true_resnorm"] <= 1e-10 and float(ref.true_resnorm) <= 1e-10
    assert _rel(got["x"], ref.x.numpy()) <= 1e-6
    assert _rel(got["x"], xstar) <= 1e-6 and _rel(ref.x.numpy(), xstar) <= 1e-6


@pytest.mark.parametrize("direction", ("dn", "up"))
@pytest.mark.parametrize("s", SHIFTS)
def test_shift_primitives_match_a_model_of_the_flat_rows(runs, direction, s):
    rows = np.arange(4 * P_LOC_SHIFT) + 1.0  # row j holds j + 1
    want = np.zeros_like(rows)
    if direction == "dn":
        want[s:] = rows[:-s]
    else:
        want[:rows.size - s] = rows[s:]
    got = np.concatenate([r[(direction, s)] for r in runs["ranks"]["shift"]])
    np.testing.assert_array_equal(got, want)


def test_mesh_shape_coords_and_axis_permutation(runs):
    m = runs["ranks"]["mesh"]
    assert m["coords"] == {"data": 0, "model": 0} and m["rank"] == 0
    # fewer ranks than a pod: the JAX stand-ins (2, W//2) and (2, 2, W//4)
    assert m["production"] == {"data": 2, "model": 2}
    assert m["multi_pod"] == {"pod": 2, "data": 2, "model": 1}
    # along "model" only: within each data row
    assert sorted(m["perm_model"]) == [(0, 1), (2, 3)]


def test_the_mesh_needs_a_card_unless_a_device_is_named(runs):
    if torch.cuda.is_available():
        assert runs["ranks"]["no_device"] == "card"
    else:
        assert "no CUDA device" in runs["ranks"]["no_device"]


def test_unknown_variant_and_auto_without_band_raise():
    stand_in = types.SimpleNamespace(size=4, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown distributed SaP variant"):
        D.build_dist_sap(stand_in, N, K, variant="F")
    with pytest.raises(ValueError, match="needs the band rows"):
        D.build_dist_sap(stand_in, N, K, variant="auto")
