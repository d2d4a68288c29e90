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
sliding window), phi-3-vision (patches split over "data"), RWKV6,
Zamba2 (the segment-aligned ``in_proj`` and conv, B and C gathered),
deepseek-moe ("ep", shared experts), mixtral ("ep" with 4 experts, and
"tp" with the gated experts' ``wi`` split by segments), whisper (frames
split over "data", the tied head over the vocabulary) and stablelm at
``remat="full"``.

MoE: the ``aux`` term on its own within 1e-5 relative of JAX's (it is
under 1% of the loss, so a load balance of per-rank statistics would pass
the loss's tolerance), and every route (each token's top-k experts, per
layer) equal to JAX's, whose layer inputs are rebuilt here from the JAX
package's own block functions.  remat: the gradients equal the no-remat
ranks', and the replay sends a layer's forward "model" all-reduces again
up to the last one the backward reads (one a stablelm layer).

Tolerances, those of ``tests/test_torch_loss_grad.py``: the loss within
1e-5 relative of JAX's and of the port's local loss; each gathered
gradient leaf within 1e-4 of its largest magnitude (the same float32
model with the products' partial sums taken over two ranks).  Every rank
of a "model" line ends with the same loss.

ZeRO-1: one ``make_train_step(mesh=...)`` step with ``zero1=True`` at
lr 1e-4 (stablelm and Zamba2, and stablelm in two microbatches) against
the single process's step: loss and grad_norm within
1e-5 relative, and each leaf's update within 1e-2 of its norm.  A
compressed ZeRO-1 stablelm step (``grad_compress=True``) against the
port's single-process compressed step and JAX's ``make_train_step``: the
same, and the gathered int8 error state within one quantization step
(each JAX leaf's scale) of JAX's elementwise, under 1% of the elements a
step apart (where a code flips).

Planted faults, each run on the ranks and each breaking the limit its
test sets: ``router_partial`` (the gates' gradient not summed over
"model"), ``aux_local`` (the load balance from each rank's own ``frac``
and ``mean_prob``) and ``scale_local`` (a split leaf's int8 scale from
the rank's block alone).  Adam's
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
MOE_CASES = ["deepseek-moe-16b", "mixtral-tp", "mixtral-8x22b"]
CASES = ["stablelm-1.6b", "stablelm-tied", "minitron-8b", "starcoder2-15b",
         "phi-3-vision-4.2b", "rwkv6-1.6b", "zamba2-2.7b", *MOE_CASES, "whisper-medium",
         "stablelm-remat"]
# a step case and its microbatch count
STEP_CASES = {"stablelm-1.6b": 1, "zamba2-2.7b": 1, "stablelm-micro2": 2,
              "stablelm-compress": 1}
# the share of the error state's elements allowed a quantization step apart
CODE_FLIP_SHARE = 1e-2
ROUND_TRIP = ["stablelm-1.6b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-medium"]


def _configs(case):
    from repro_torch.configs import get_config

    name = {"mixtral-tp": "mixtral-8x22b"}.get(
        case, "stablelm-1.6b" if case.startswith("stablelm") else case)
    extra = {"compute_dtype": "float32"}
    if case == "stablelm-tied":
        extra["tie_embeddings"] = True
    if case == "stablelm-remat":
        extra["remat"] = "full"
    if case == "mixtral-tp":
        extra["expert_sharding"] = "tp"
    return (dataclasses.replace(jax_config(name, reduced=True), **extra),
            dataclasses.replace(get_config(name, reduced=True), **extra))


def _weights(case):
    """The case whose JAX weights a step or remat case takes."""
    return "stablelm-1.6b" if case.startswith("stablelm-") and case != "stablelm-tied" else case


def _train_config(case, **kw):
    """The ``TrainConfig`` fields of a step case (either package's)."""
    return {"microbatches": STEP_CASES[case], "grad_compress": case == "stablelm-compress", **kw}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax_params(case):
    jc, _ = _configs(_weights(case))
    init = jax.jit(functools.partial(jax_family(jc).init, jc))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _jax_routes(jc, params, tokens):
    """Each MoE layer's top-k experts (NG, G, k) in the JAX package: the
    layer input rebuilt with its own block functions, layer by layer."""
    from repro.models import transformer as jt
    from repro.models.layers import rms_norm

    x = jnp.take(params["embed"], tokens, axis=0).astype(jc.cdtype)
    positions = jnp.arange(tokens.shape[1])
    group = min(jc.moe_group, tokens.size)
    routes = []
    for i in range(jc.n_layers):
        p = jax.tree.map(lambda a: a[i], params["blocks"])
        x1 = x + jt._attention(jc, p["attn"], rms_norm(x, p["ln1"]), positions)
        h = rms_norm(x1, p["ln2"]).reshape(-1, group, jc.d_model).astype(jnp.float32)
        probs = jax.nn.softmax(h @ p["moe"]["router"], axis=-1)
        routes.append(jax.lax.top_k(probs, jc.top_k)[1])
        x, _ = jt._block_fwd(jc, p, x, positions)
    return routes


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
    from repro_torch.models import get_family, moe, sharded
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.train import loop
    from repro_torch.train.loop import (
        TrainConfig,
        init_sharded_error_state,
        init_sharded_opt_state,
        make_train_step,
    )

    torch.set_num_threads(1)
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"loss": {}, "step": {}, "round_trip": {}, "faults": {}}
    routes = []
    route_plain = moe.route

    def route_recorded(*a):
        got = route_plain(*a)
        routes.append(got[3].detach().numpy().copy())
        return got

    def loss_case(case, tc):
        fam = get_family(tc)
        model = params_from_jax(tc, params[_weights(case)], device="cpu")
        local, batch = _rank_blocks(tc, fam, model, _batch(tc, len(_weights(case))), mesh)
        routes.clear()
        D.reset_comm_stats()
        loss, grads = sharded.value_and_grad(tc, local, batch, mesh)
        comm, got_routes = D.comm_stats()["by_axis"], list(routes)
        full = sharded.gather_tree(tc, grads, mesh)
        with torch.no_grad():  # the aux term alone, averaged over "data"
            aux = fam.loss(tc, local, batch, mesh=mesh)[1]["aux"].reshape(1)
        aux = D.all_reduce_axis(aux, mesh, "data") / mesh.shape["data"]
        losses, rank_routes = [None] * 4, [None] * 4
        dist.all_gather_object(losses, float(loss))
        dist.all_gather_object(rank_routes, (mesh.axis_index(("data",)), got_routes))
        return {"loss": float(loss), "losses": losses, "aux": float(aux), "comm": comm,
                "routes": rank_routes, "grads": params_to_jax(model, full)}

    moe.route = route_recorded
    try:
        for case in CASES:
            out["loss"][case] = loss_case(case, _configs(case)[1])
    finally:
        moe.route = route_plain
    for case in STEP_CASES:
        _, tc = _configs(case)
        fam = get_family(tc)
        model = params_from_jax(tc, params[_weights(case)], device="cpu")
        local, batch = _rank_blocks(tc, fam, model, _batch(tc, len(case)), mesh)
        oc = optim.AdamWConfig(lr=LR, warmup_steps=0)
        state = init_sharded_opt_state(tc, local, mesh, zero1=True)
        err = init_sharded_error_state(tc, local, mesh)
        tcfg = TrainConfig(**_train_config(case, zero1=True))
        step = make_train_step(tc, oc, tcfg, mesh=mesh)
        pbytes = sum(p.numel() * 4 for p in local.parameters())
        obytes = sum(t.numel() * 4 for t in [*state.m.values(), *state.v.values()])
        metrics, stats = step_stats(lambda: step(local, state, err, batch), pbytes, obytes)
        full = sharded.gather_model(tc, local, mesh)
        out["step"][case] = {
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": params_to_jax(full),
            "m_shapes": {n: tuple(t.shape) for n, t in state.m.items()},
            "local_shapes": {n: tuple(p.shape) for n, p in local.named_parameters()},
            "stats": stats}
        if tcfg.grad_compress:
            out["step"][case]["err"] = params_to_jax(full, sharded.gather_tree(tc, err, mesh))
    # every gradient cut into pieces of 1,000 elements: the same average
    bucket = sharded.GRAD_BUCKET_ELEMENTS
    sharded.GRAD_BUCKET_ELEMENTS = 1000
    try:
        out["small_buckets"] = loss_case("stablelm-1.6b", _configs("stablelm-1.6b")[1])
    finally:
        sharded.GRAD_BUCKET_ELEMENTS = bucket
    # planted faults: each must break the limit its test sets
    _, tc = _configs("deepseek-moe-16b")
    gates_plain, balance_plain = moe.combine_gates, moe.balance_mean
    try:
        moe.combine_gates = lambda g, mesh_: g
        out["faults"]["router_partial"] = loss_case("deepseek-moe-16b", tc)
        moe.combine_gates = gates_plain
        moe.balance_mean = lambda t, mesh_: t
        out["faults"]["aux_local"] = loss_case("deepseek-moe-16b", tc)
    finally:
        moe.combine_gates, moe.balance_mean = gates_plain, balance_plain
    _, tc = _configs("stablelm-compress")
    model = params_from_jax(tc, params["stablelm-1.6b"], device="cpu")
    local, batch = _rank_blocks(tc, get_family(tc), model, _batch(tc, len("stablelm-compress")),
                                mesh)
    err = init_sharded_error_state(tc, local, mesh)
    step = make_train_step(tc, optim.AdamWConfig(lr=LR, warmup_steps=0),
                           TrainConfig(**_train_config("stablelm-compress", zero1=True)),
                           mesh=mesh)
    scale_plain = loop.scale_over_model
    loop.scale_over_model = lambda top, mesh_, split_leaf: top
    try:
        step(local, init_sharded_opt_state(tc, local, mesh, zero1=True), err, batch)
    finally:
        loop.scale_over_model = scale_plain
    out["faults"]["scale_local"] = params_to_jax(model, sharded.gather_tree(tc, err, mesh))
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


def _jax_case(case, params):
    """JAX's loss, gradient and aux term of a loss case (and its routes)."""
    jc, _ = _configs(case)
    batch = {k: jnp.asarray(v) for k, v in _batch(jc, len(_weights(case))).items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(functools.partial(jax_family(jc).loss, jc),
                                              has_aux=True))(params[_weights(case)], batch)
    out = {"jax": (float(jl), jax.tree.map(np.asarray, jg), float(jm["aux"]))}
    if case in MOE_CASES:
        routes = jax.jit(functools.partial(_jax_routes, jc))(params[case], batch["tokens"])
        out["routes"] = [np.asarray(r) for r in routes]
    return out


def _jax_step(case, params):
    """JAX's ``make_train_step`` of a step case from a fresh state."""
    from repro import optim as jopt
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_make_train_step

    jc, _ = _configs(case)
    jp = params[_weights(case)]
    jstep = jax.jit(jax_make_train_step(jc, jopt.AdamWConfig(lr=LR, warmup_steps=0),
                                        JaxTrainConfig(**_train_config(case))))
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jc, len(case)).items()}
    jp1, _, je, jm = jstep(jp, jopt.init(jp), jopt.compress.init_error_state(jp), jbatch)
    return {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
            "params": jax.tree.map(np.asarray, jp1), "err": jax.tree.map(np.asarray, je)}


def _references(params):
    """JAX's value_and_grad (and a MoE case's routes), the port's
    single-process loss, the port's single-process step, and JAX's
    compressed step, on the same weights and batches.  The JAX programs
    compile in a few threads while the port's references run."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import optim
    from repro_torch.models import get_family
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.train.loop import TrainConfig, make_train_step

    out = {"jax": {}, "port": {}, "step": {}, "routes": {}, "jax_step": {}}
    compressed = [c for c in STEP_CASES if _train_config(c)["grad_compress"]]
    with ThreadPoolExecutor(3) as pool:
        jax_cases = {c: pool.submit(_jax_case, c, params) for c in CASES}
        jax_steps = {c: pool.submit(_jax_step, c, params) for c in compressed}
        for case in CASES:
            _, tc = _configs(case)
            batch = _batch(tc, len(_weights(case)))
            model = params_from_jax(tc, params[_weights(case)], device="cpu")
            with torch.no_grad():
                tl, _ = get_family(tc).loss(tc, model,
                                            {k: torch.tensor(v) for k, v in batch.items()})
            out["port"][case] = float(tl)
        for case in STEP_CASES:
            _, tc = _configs(case)
            batch = {k: torch.tensor(v) for k, v in _batch(tc, len(case)).items()}
            model = params_from_jax(tc, params[_weights(case)], device="cpu").requires_grad_(True)
            named = dict(model.named_parameters())
            if case in compressed:
                # a fresh error state: each leaf's quantization step is
                # max |g| / 127, of the port's single-process gradient
                # (JAX's within float32 rounding)
                get_family(tc).loss(tc, model, batch)[0].backward()
                grads = params_to_jax(model, {n: p.grad for n, p in named.items()})
                out["jax_step"][case] = {
                    "qstep": jax.tree.map(lambda g: float(np.abs(g).max()) / 127.0, grads)}
            step = make_train_step(tc, optim.AdamWConfig(lr=LR, warmup_steps=0),
                                   TrainConfig(**_train_config(case)))
            m = step(model, optim.init(named), optim.compress.init_error_state(named), batch)
            out["step"][case] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                 "params": params_to_jax(model)}
        for case, fut in jax_cases.items():
            got = fut.result()
            out["jax"][case] = got["jax"]
            if "routes" in got:
                out["routes"][case] = got["routes"]
        for case, fut in jax_steps.items():
            out["jax_step"][case].update(fut.result())
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import spawn_ranks

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        weights = list(dict.fromkeys(_weights(c) for c in CASES))
        params = dict(zip(weights, pool.map(_jax_params, weights)))
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


def _route_flips(want: list, got: list) -> int:
    """Routed slots (token, choice) whose expert differs from JAX's, over
    every layer and rank: each rank's groups are its data block's."""
    flips = 0
    for data_index, layers in got:
        assert len(layers) == len(want)
        for w, g in zip(want, layers):
            ng = g.shape[0]
            flips += int(np.sum(w[data_index * ng:(data_index + 1) * ng] != g))
    return flips


def _router_error(want: dict, got: dict) -> float:
    """The routers' gradient difference over their largest magnitude."""
    a = np.asarray(want["blocks"]["moe"]["router"])
    b = np.asarray(got["blocks"]["moe"]["router"])
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


def _err_state_reading(want: dict, got: dict, qstep: dict) -> tuple[float, float]:
    """(the largest |error difference| in quantization steps, the share of
    elements more than half a step apart -- a flipped int8 code)."""
    worst, apart, total = 0.0, 0, 0
    for path, a in _leaves(want):
        step = _get(qstep, path)
        d = np.abs(a - np.asarray(_get(got, path))) / step
        worst = max(worst, float(d.max()))
        apart += int(np.sum(d > 0.5))
        total += d.size
    return worst, apart / total


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_aux_term_equals_jax(runs, case):
    """The load balance and z-loss alone: under 1% of the loss, so the
    loss's tolerance cannot see a wrong load balance."""
    want = runs["jax"][case][2]
    assert want > 0
    assert abs(runs["ranks"]["loss"][case]["aux"] - want) <= LOSS_RTOL * want


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routes_equal_jax(runs, case):
    got = runs["ranks"]["loss"][case]["routes"]
    want = runs["routes"][case]
    assert all(len(layers) == runs["params"][case]["blocks"]["ln1"].shape[0] for _, layers in got)
    assert _route_flips(want, got) == 0


def test_remat_gradients_equal_the_plain_ranks_and_replay_the_forward_all_reduces(runs):
    """stablelm at remat="full" on the ranks: the gradients of the no-remat
    ranks, and each layer's forward "model" all-reduces sent once more in
    the backward's replay, (B/2, T, D) float32 each, up to the last tensor
    the backward reads (the checkpoint's early stop): the attention's
    row-parallel sum, which the MLP's norm reads; the MLP's own sum ends
    the layer, and no saved tensor needs it."""
    _, tc = _configs("stablelm-1.6b")
    plain, rem = runs["ranks"]["loss"]["stablelm-1.6b"], runs["ranks"]["loss"]["stablelm-remat"]
    assert rem["loss"] == plain["loss"]
    for path, a in _leaves(plain["grads"]):
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - np.asarray(_get(rem["grads"], path))).max()) <= 1e-6 * scale, path
    extra = tc.n_layers
    act = (B // 2) * T * tc.d_model * 4
    base, got = plain["comm"]["all_reduce/model"], rem["comm"]["all_reduce/model"]
    assert got == {"messages": base["messages"] + extra, "bytes": base["bytes"] + extra * act}
    assert rem["comm"]["all_reduce/data"] == plain["comm"]["all_reduce/data"]


def test_compressed_zero1_step_equals_jax_and_the_single_process(runs):
    case = "stablelm-compress"
    got = runs["ranks"]["step"][case]
    p0 = runs["params"][_weights(case)]
    for want in (runs["step"][case], runs["jax_step"][case]):
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= LOSS_RTOL * abs(want["grad_norm"])
        for path, a in _leaves(want["params"]):
            du_want = a - np.asarray(_get(p0, path))
            du_got = np.asarray(_get(got["params"], path)) - np.asarray(_get(p0, path))
            err = float(np.linalg.norm(du_got - du_want))
            assert err <= UPDATE_TOL * float(np.linalg.norm(du_want)), path


def test_compressed_error_state_within_a_quantization_step_of_jax(runs):
    case = "stablelm-compress"
    want = runs["jax_step"][case]
    worst, apart = _err_state_reading(want["err"], runs["ranks"]["step"][case]["err"],
                                      want["qstep"])
    assert worst <= 1.0 + 1e-3
    assert apart < CODE_FLIP_SHARE


@pytest.mark.parametrize("fault", ["router_partial", "aux_local", "scale_local"])
def test_planted_fault_breaks_its_limit(runs, fault):
    """Each fault, injected into the ranks, fails the limit that the sound
    run passes above: the router's gradient (GRAD_TOL of its largest), the
    aux term (LOSS_RTOL), the error state (CODE_FLIP_SHARE of the elements
    a step apart)."""
    got = runs["ranks"]["faults"][fault]
    if fault == "router_partial":
        assert _router_error(runs["jax"]["deepseek-moe-16b"][1], got["grads"]) > GRAD_TOL
    elif fault == "aux_local":
        want = runs["jax"]["deepseek-moe-16b"][2]
        assert abs(got["aux"] - want) > LOSS_RTOL * want
    else:
        want = runs["jax_step"]["stablelm-compress"]
        worst, apart = _err_state_reading(want["err"], got, want["qstep"])
        assert apart >= CODE_FLIP_SHARE or worst > 1.0 + 1e-3


def test_gradients_cut_into_small_buckets_average_the_same(runs):
    """reduce_grads with a 1,000-element bucket: every gradient larger
    than a bucket cut into pieces, many more messages over "data", the
    same averaged gradients."""
    got, want = runs["ranks"]["small_buckets"], runs["ranks"]["loss"]["stablelm-1.6b"]
    n_elements = sum(int(np.prod(a.shape)) for _, a in _leaves(want["grads"])) // 2
    assert got["comm"]["all_reduce/data"]["messages"] > n_elements // 1000
    for path, a in _leaves(want["grads"]):
        assert np.array_equal(a, np.asarray(_get(got["grads"], path))), path
