"""The sharded LM loss, its gradients and the ZeRO-1 step on four gloo
ranks of the CPU, against the JAX package and the port's single process.

Four ranks on a (2, 2) ("data", "model") mesh, started once for the module
(``spawn_ranks``), each take their blocks of the parameters
(``shard_model`` by ``param_pspecs``) and of the batch (``batch_pspecs``),
and run ``models/sharded.py``'s loss and gradient (each family's own
``loss`` given the mesh); the JAX reference
(``jax.value_and_grad`` of the family's ``loss``) and the port's
single-process loss run in this process meanwhile.  Every case is a
reduced configuration in float32 compute with the JAX init's weights
(``params_from_jax``), B = 4, T = 32: stablelm (MHA, gated MLP), stablelm
with tied embeddings, minitron (GQA, plain MLP), starcoder2 (GQA and the
sliding window), phi-3-vision (patches split over "data"), RWKV6 and
Zamba2 (the segment-aligned ``in_proj`` and conv, B and C gathered).

Tolerances, those of ``tests/test_torch_loss_grad.py``: the loss within
1e-5 relative of JAX's and of the port's local loss; each gathered
gradient leaf within 1e-4 of its largest magnitude (the same float32
model with the products' partial sums taken over two ranks).  Every rank
of a "model" line ends with the same loss.

ZeRO-1: one ``make_train_step(mesh=...)`` step with ``zero1=True`` at
lr 1e-4 (stablelm and Zamba2, and stablelm in two microbatches) against
the single process's step: loss and grad_norm within
1e-5 relative, and each leaf's update within 1e-2 of its norm.  Adam's
first update is ~lr sign(g), so a gradient's rounding moves an element
by up to lr where the gradient is near zero: the updates differ by 1.5e-3
of their norm at most (Zamba2's shared ``wk``), where a rank updating
the wrong slice would differ by ~1.  The moments' blocks have
zero1_pspecs's shapes.  The collective bytes of the stablelm step
(``step_stats``) against a count from the shapes.  The mesh's axis
groups: none for an axis of size 1, and a mesh over a group that is not
the world refuses to split two axes.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, T = 4, 32
LR = 1e-4
UPDATE_TOL = 1e-2
CASES = ["stablelm-1.6b", "stablelm-tied", "minitron-8b", "starcoder2-15b",
         "phi-3-vision-4.2b", "rwkv6-1.6b", "zamba2-2.7b"]
# a step case and its microbatch count
STEP_CASES = {"stablelm-1.6b": 1, "zamba2-2.7b": 1, "stablelm-micro2": 2}
ROUND_TRIP = ["stablelm-1.6b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-medium"]


def _configs(case):
    from repro_torch.configs import get_config

    name = "stablelm-1.6b" if case in ("stablelm-tied", "stablelm-micro2") else case
    extra = {"compute_dtype": "float32"}
    if case == "stablelm-tied":
        extra["tie_embeddings"] = True
    return (dataclasses.replace(jax_config(name, reduced=True), **extra),
            dataclasses.replace(get_config(name, reduced=True), **extra))


def _weights(case):
    """The case whose JAX weights a step case takes."""
    return "stablelm-1.6b" if case == "stablelm-micro2" else case


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _jax_params(case):
    jc, _ = _configs(case)
    return jax.tree.map(np.asarray, jax_family(jc).init(jc, jax.random.PRNGKey(0)))


def _rank_blocks(tc, fam, model, batch, mesh):
    from repro_torch.launch.sharding import local_shard
    from repro_torch.models import sharded
    from repro_torch.models.api import ShapeSpec

    local = sharded.shard_model(tc, model, mesh)
    spec = fam.batch_pspecs(tc, ShapeSpec("t", T, B, "train"), mesh)
    return local, {k: local_shard(torch.tensor(v), spec[k], mesh) for k, v in batch.items()}


def _ranks_body(params):
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import step_stats
    from repro_torch.models import get_family, sharded
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.train.loop import TrainConfig, init_sharded_opt_state, make_train_step

    torch.set_num_threads(1)
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"loss": {}, "step": {}, "round_trip": {}}
    for case in CASES:
        _, tc = _configs(case)
        fam = get_family(tc)
        model = params_from_jax(tc, params[case], device="cpu")
        local, batch = _rank_blocks(tc, fam, model, _batch(tc, len(case)), mesh)
        loss, grads = sharded.value_and_grad(tc, local, batch, mesh)
        full = sharded.gather_tree(tc, grads, mesh)
        losses = [None] * 4
        dist.all_gather_object(losses, float(loss))
        out["loss"][case] = {"loss": float(loss), "losses": losses,
                             "grads": params_to_jax(model, full)}
    for case in STEP_CASES:
        _, tc = _configs(case)
        fam = get_family(tc)
        model = params_from_jax(tc, params[_weights(case)], device="cpu")
        local, batch = _rank_blocks(tc, fam, model, _batch(tc, len(case)), mesh)
        oc = optim.AdamWConfig(lr=LR, warmup_steps=0)
        state = init_sharded_opt_state(tc, local, mesh, zero1=True)
        tcfg = TrainConfig(zero1=True, microbatches=STEP_CASES[case])
        step = make_train_step(tc, oc, tcfg, mesh=mesh)
        pbytes = sum(p.numel() * 4 for p in local.parameters())
        obytes = sum(t.numel() * 4 for t in [*state.m.values(), *state.v.values()])
        metrics, stats = step_stats(lambda: step(local, state, {}, batch), pbytes, obytes)
        full = sharded.gather_model(tc, local, mesh)
        out["step"][case] = {
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": params_to_jax(full),
            "m_shapes": {n: tuple(t.shape) for n, t in state.m.items()},
            "local_shapes": {n: tuple(p.shape) for n, p in local.named_parameters()},
            "stats": stats}
    for name in ROUND_TRIP:
        from repro_torch.configs import get_config

        tc = get_config(name, reduced=True)
        model = get_family(tc).init(tc, torch.Generator().manual_seed(3), device="cpu")
        back = sharded.gather_model(tc, sharded.shard_model(tc, model, mesh), mesh)
        out["round_trip"][name] = all(
            torch.equal(a, b) for a, b in zip(model.parameters(), back.parameters()))
    _, tc = _configs("stablelm-1.6b")
    try:  # one KV head cannot split over model = 2
        one_kv = dataclasses.replace(tc, n_kv_heads=1)
        m1 = get_family(one_kv).init(one_kv, torch.Generator().manual_seed(0), device="cpu")
        sharded.loss(one_kv, sharded.shard_model(one_kv, m1, mesh),
                     {"tokens": torch.zeros((2, T), dtype=torch.int64)}, mesh)
        out["gqa_error"] = None
    except ValueError as exc:
        out["gqa_error"] = str(exc)
    # an axis of size 1 gets no subgroup; a mesh over a group that is not
    # the world splits at most one axis (its ranks alone cannot build more)
    out["size1_group"] = make_test_mesh((1, 4), ("data", "model"), device="cpu").axis_group("data")
    group = dist.new_group([0, 1, 2, 3])
    try:
        make_test_mesh((2, 2), ("data", "model"), group=group, device="cpu")
        out["subgroup_error"] = None
    except ValueError as exc:
        out["subgroup_error"] = str(exc)
    # no rank leaves while a peer still connects to the new group
    dist.barrier()
    out["comm"] = D.comm_stats()
    return out if dist.get_rank() == 0 else None


def _references(params):
    """JAX's value_and_grad, the port's single-process loss, and the port's
    single-process step, on the same weights and batches."""
    from repro_torch import optim
    from repro_torch.models import get_family
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.train.loop import TrainConfig, make_train_step

    out = {"jax": {}, "port": {}, "step": {}}
    for case in CASES:
        jc, tc = _configs(case)
        batch = _batch(jc, len(case))
        (jl, _), jg = jax.jit(jax.value_and_grad(functools.partial(jax_family(jc).loss, jc),
                                                 has_aux=True))(
            params[case], {k: jnp.asarray(v) for k, v in batch.items()})
        out["jax"][case] = (float(jl), jax.tree.map(np.asarray, jg))
        model = params_from_jax(tc, params[case], device="cpu")
        with torch.no_grad():
            tl, _ = get_family(tc).loss(tc, model, {k: torch.tensor(v) for k, v in batch.items()})
        out["port"][case] = float(tl)
    for case in STEP_CASES:
        _, tc = _configs(case)
        model = params_from_jax(tc, params[_weights(case)], device="cpu").requires_grad_(True)
        state = optim.init(dict(model.named_parameters()))
        step = make_train_step(tc, optim.AdamWConfig(lr=LR, warmup_steps=0),
                               TrainConfig(microbatches=STEP_CASES[case]))
        m = step(model, state, {}, {k: torch.tensor(v) for k, v in _batch(tc, len(case)).items()})
        out["step"][case] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "params": params_to_jax(model)}
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import spawn_ranks

    params = {case: _jax_params(case) for case in CASES}
    got = {}

    def ranks():
        try:
            got["ranks"] = spawn_ranks(_ranks_body, 4, args=(params,), timeout=240)[0]
        except BaseException as exc:  # reported below
            got["error"] = exc

    th = threading.Thread(target=ranks)
    th.start()
    try:
        refs = _references(params)
    finally:
        th.join()
    if "error" in got:
        raise got["error"]
    return {"ranks": got["ranks"], "params": params, **refs}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_equals_jax_and_the_local_loss(runs, case):
    got = runs["ranks"]["loss"][case]
    jl = runs["jax"][case][0]
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - jl) <= LOSS_RTOL * abs(jl)
    assert abs(got["loss"] - runs["port"][case]) <= LOSS_RTOL * abs(jl)
    assert len(set(got["losses"])) == 1  # the data mean: every rank the same


@pytest.mark.parametrize("case", CASES)
def test_gathered_gradients_equal_jax(runs, case):
    want = runs["jax"][case][1]
    got = runs["ranks"]["loss"][case]["grads"]
    assert {p for p, _ in _leaves(want)} == {p for p, _ in _leaves(got)}
    for path, a in _leaves(want):
        b = np.asarray(_get(got, path))
        assert a.shape == b.shape, path
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= GRAD_TOL * scale, f"{case} {'/'.join(path)}: {err:.3e} > {GRAD_TOL} x {scale:.3e}"


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_zero1_step_equals_the_single_process_step(runs, case):
    got, want = runs["ranks"]["step"][case], runs["step"][case]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= LOSS_RTOL * abs(want["grad_norm"])
    for path, a in _leaves(want["params"]):
        p0 = np.asarray(_get(runs["params"][_weights(case)], path))
        du_want, du_got = a - p0, np.asarray(_get(got["params"], path)) - p0
        err = float(np.linalg.norm(du_got - du_want))
        assert err <= UPDATE_TOL * float(np.linalg.norm(du_want)), path


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_zero1_moments_are_each_data_ranks_slice(runs, case):
    """Each moment block is the rank's parameter block with the dimension
    ``zero1_pspecs`` gives "data" halved."""
    from repro_torch import optim
    from repro_torch.models.sharded import param_specs

    class Shape:
        shape = {"data": 2, "model": 2}

    _, tc = _configs(case)
    got = runs["ranks"]["step"][case]
    specs = param_specs(tc, Shape())
    mspecs = optim.zero1_pspecs(specs, got["local_shapes"], Shape())
    sliced = 0
    for n, local in got["local_shapes"].items():
        want = list(local)
        entries = list(mspecs[n]) + [None] * (len(local) - len(mspecs[n]))
        for i, (a, b) in enumerate(zip(entries, list(specs[n]) + [None] * len(local))):
            if a == "data" and b != "data":
                want[i] //= 2
                sliced += 1
        assert got["m_shapes"][n] == tuple(want), n
    assert sliced >= len(got["local_shapes"]) // 2


def test_round_trip_of_every_family_through_the_ranks(runs):
    assert runs["ranks"]["round_trip"] == {n: True for n in ROUND_TRIP}


def test_kv_heads_that_do_not_split_raise(runs):
    assert "n_kv_heads = 1 does not split" in runs["ranks"]["gqa_error"]


def test_an_axis_of_size_one_gets_no_subgroup(runs):
    assert runs["ranks"]["size1_group"] is None


def test_a_subgroup_mesh_that_splits_two_axes_raises(runs):
    assert "splits at most one axis" in runs["ranks"]["subgroup_error"]


def test_collective_bytes_of_the_dense_step_match_the_shapes(runs):
    """stablelm (reduced, float32 compute) on (2, 2): per rank, over
    "model": the embedding's all-reduce, two row-parallel all-reduces a
    layer, the head's max / sum / target all-reduces, and backward the
    column-parallel inputs' gradients (two a layer and the head's), all
    (B/2, T, D) float32 but the loss's (B/2, T-1); the global norm's
    scalar.  Over "data": one bucket of every gradient and the loss's
    scalar; ZeRO-1's gathers of every parameter it slices."""
    _, tc = _configs("stablelm-1.6b")
    got = runs["ranks"]["step"]["stablelm-1.6b"]
    detail = got["stats"]["coll_detail"]
    bl, d, layers = B // 2, tc.d_model, tc.n_layers
    act = bl * T * d * 4
    model_msgs = (1 + 2 * layers + 3) + (2 * layers + 1) + 1
    model_bytes = act * (1 + 2 * layers) + 3 * bl * (T - 1) * 4 + act * (2 * layers + 1) + 4
    assert detail["all_reduce/model"] == {"messages": model_msgs, "bytes": model_bytes}
    n_local = sum(int(np.prod(s)) for s in got["local_shapes"].values())
    assert detail["all_reduce/data"] == {"messages": 2, "bytes": 4 * n_local + 4}
    sliced = [s for n, s in got["local_shapes"].items() if got["m_shapes"][n] != s]
    assert detail["all_gather/data"] == {"messages": len(sliced),
                                         "bytes": 4 * sum(int(np.prod(s)) for s in sliced)}
    assert set(detail) == {"all_reduce/model", "all_reduce/data", "all_gather/data"}
    assert got["stats"]["coll_bytes"] == sum(v["bytes"] for v in detail.values())
    assert got["stats"]["flops"] > 0 and got["stats"]["saved_bytes"] > 0
