"""The port's mixture of experts and the MoE / VLM transformers against the
JAX package.

``moe_mlp`` (outputs and aux loss) against ``repro.models.moe.moe_mlp``
at the reduced deepseek-moe and mixtral configurations, with a capacity
that drops slots (``moe_group=16``, ``capacity_factor=0.5``) and with the
shared experts off; the slot ranks, the capacity's half-to-even rounding,
ties in the router and ``init_moe``'s shapes and scales.  Reduced
deepseek-moe-16b, mixtral-8x22b and phi-3-vision-4.2b (float32), the JAX
parameters carried across by ``params_from_jax``: ``forward`` (logits and
aux), ``forward`` with prepended patches, ``decode_step`` token by token
against the JAX package's (mixtral past its window of 32), decode against
the port's own forward at a capacity that drops nothing, and the port's
own ``init``.  ``params_count``, ``active_params`` and ``model_flops`` of
every architecture at every ``SHAPES`` entry against the JAX package's.

Tolerance: rtol = atol = 2e-4 on logits, outputs and aux losses, as in
``test_torch_transformer.py`` -- the same float32 model with the sums of
the dispatch products taken in another order (the differences seen are
~1e-6 on logits of size ~0.7).  Routing, ranks, capacities and parameter
counts are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_names as jax_arch_names
from repro.configs import get_config as jax_config
from repro.launch import roofline as jax_roofline
from repro.models import get_family as jax_family
from repro.models import moe as jax_moe
from repro.models.api import SHAPES as JAX_SHAPES
from repro_torch.configs import arch_names, get_config
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.models import get_family, moe, transformer
from repro_torch.models.api import SHAPES
from repro_torch.models.convert import _tensors, params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
MOE = ["deepseek-moe-16b", "mixtral-8x22b"]
MODELS = MOE + ["phi-3-vision-4.2b"]
# (arch, overrides): the reduced configuration, a capacity that drops
# slots, and the shared experts off
MLP_CASES = [(a, {}) for a in MOE] + [
    (a, {"moe_group": 16, "capacity_factor": 0.5}) for a in MOE] + [
    ("deepseek-moe-16b", {"n_shared_experts": 0})]


def _configs(name, **over):
    return (dataclasses.replace(jax_config(name, reduced=True), **over),
            dataclasses.replace(get_config(name, reduced=True), **over))


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


def _long(a):
    return torch.tensor(a, dtype=torch.long)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,over", MLP_CASES, ids=lambda v: str(v))
def test_moe_mlp_matches_jax(name, over):
    jc, tc = _configs(name, **over)
    jp = jax_moe.init_moe(jc, jax.random.PRNGKey(0))
    tp = _tensors(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(0).normal(size=(2, 32, jc.d_model)).astype(np.float32)
    y, aux = jax_moe.moe_mlp(jc, jp, x)
    ty, taux = moe.moe_mlp(tc, tp, torch.tensor(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), **TOL)
    dropped, routed = moe.slot_counts(tc, tp["router"], torch.tensor(x))
    assert routed == 2 * 32 * tc.top_k
    assert (int(dropped) > 0) == ("capacity_factor" in over)
    assert ("shared" in tp) == (tc.n_shared_experts > 0)


def test_slot_ranks_capacity_and_router_ties_match_jax():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 5, size=40)
    np.testing.assert_array_equal(
        moe._positions_in_expert(_long(idx), 5).numpy(),
        np.asarray(jax_moe._positions_in_expert(jnp.asarray(idx), 5)))
    # half to even: 2.5 -> 2, 3.5 -> 4, and at least one slot
    for group, cf, want in ((5, 1.0, 2), (7, 1.0, 4), (1, 0.01, 1), (64, 1.25, 40)):
        cfg = dataclasses.replace(get_config("mixtral-8x22b", reduced=True), n_experts=4,
                                  capacity_factor=cf)
        assert moe.capacity(cfg, group) == want
    # a zero router: every probability ties, and both packages take the
    # lowest expert indices, in order
    jc, tc = _configs("deepseek-moe-16b")
    jp = jax_moe.init_moe(jc, jax.random.PRNGKey(1))
    jp["router"] = jnp.zeros_like(jp["router"])
    tp = _tensors(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(1, 8, jc.d_model)).astype(np.float32)
    _, _, gates, idx_t = moe.route(tc, tp["router"], torch.tensor(x))
    assert (idx_t == torch.arange(tc.top_k)).all()
    np.testing.assert_allclose(gates.numpy(), 1.0 / tc.top_k)
    np.testing.assert_allclose(moe.moe_mlp(tc, tp, torch.tensor(x))[0].numpy(),
                               np.asarray(jax_moe.moe_mlp(jc, jp, x)[0]), **TOL)


def test_tokens_must_fill_whole_groups():
    _, tc = _configs("mixtral-8x22b", moe_group=16)
    tp = moe.init_moe(tc, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible by group"):
        moe.moe_mlp(tc, tp, torch.zeros(2, 20, tc.d_model))


@pytest.mark.parametrize("name", MOE)
def test_init_moe_has_the_jax_shapes_and_scales(name):
    jc, tc = _configs(name)
    jp = jax_moe.init_moe(jc, jax.random.PRNGKey(0))
    want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    got = moe.init_moe(tc, torch.Generator().manual_seed(0))
    for path, leaf in want.items():
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_allclose(float(node.std()), float(np.std(leaf)), rtol=0.25,
                                   err_msg=str(path))
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(want)


# ---------------------------------------------------------------------------
# the MoE and VLM transformers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(JAX cfg, family, params) and (port cfg, family, params) of one
    reduced architecture, the same parameters in both."""
    jc, tc = _configs(request.param)
    jf = jax_family(jc)
    jp = jf.init(jc, jax.random.PRNGKey(0))
    return (jc, jf, jp), (tc, get_family(tc), params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                                              device="cpu"))


def test_forward_matches_jax(pair, monkeypatch):
    (jc, jf, jp), (tc, tf, tp) = pair
    assert tf is transformer
    calls = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    toks = _tokens(jc, 2, 64, seed=0)
    j_logits, j_aux = jf.forward(jc, jp, toks)
    t_logits, t_aux = tf.forward(tc, tp, _long(toks))
    assert t_logits.shape == (2, 64, tc.vocab_padded) and t_aux.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), **TOL)
    assert (float(t_aux) > 0) == (tc.n_experts > 0)  # summed over the layers' routers
    assert len(calls) == tc.n_layers  # the flash entry point, once a layer
    torch.testing.assert_close(tp(_long(toks))[0], t_logits)  # nn.Module


def test_forward_with_patches_matches_jax(pair):
    (jc, jf, jp), (tc, tf, tp) = pair
    n_patches = tc.n_patches or 8
    toks = _tokens(jc, 2, 56, seed=5)  # 64 rows with the patches: whole MoE groups
    patches = np.random.default_rng(6).normal(size=(2, n_patches, jc.d_model)).astype(np.float32)
    j_logits, j_aux = jf.forward(jc, jp, toks, patches)
    t_logits, t_aux = tf.forward(tc, tp, _long(toks), torch.tensor(patches))
    assert t_logits.shape == (2, n_patches + 56, tc.vocab_padded)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), **TOL)


def test_patches_change_the_text_logits():
    """The VLM stub, as tests/test_models_smoke.py holds the JAX package:
    patches of zeros and of ones give different last text logits."""
    tc = get_config("phi-3-vision-4.2b", reduced=True)
    params = transformer.init(tc, device="cpu")
    toks = _long(_tokens(tc, 1, 16, seed=7))
    p1 = torch.zeros(1, tc.n_patches, tc.d_model)
    l1, _ = transformer.forward(tc, params, toks, p1)
    l2, _ = transformer.forward(tc, params, toks, torch.ones_like(p1))
    assert l1.shape[1] == tc.n_patches + 16
    assert not torch.allclose(l1[:, -1], l2[:, -1])


def test_decode_steps_match_jax(pair):
    """Decode groups are the B rows of a step (ROADMAP R9): at B = 3 the
    reduced deepseek-moe's capacity is one slot, so slots are dropped,
    as in the JAX package's decode; mixtral's 40 steps pass its window."""
    (jc, jf, jp), (tc, tf, tp) = pair
    toks = _tokens(jc, 3, 40, seed=2)
    j_cache = jf.init_cache(jc, 3, 64)
    t_cache = tf.init_cache(tc, 3, 64, device="cpu")
    step = jax.jit(lambda p, c, t: jf.decode_step(jc, p, c, t))
    for i in range(toks.shape[1]):
        j_logits, j_cache = step(jp, j_cache, toks[:, i:i + 1])
        t_logits, t_cache = tf.decode_step(tc, tp, t_cache, _long(toks[:, i:i + 1]))
        assert t_logits.shape == (3, tc.vocab)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), err_msg=f"token {i}",
                                   **TOL)
    assert int(t_cache["len"]) == int(j_cache["len"]) == 40
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL)


def test_decode_reproduces_the_forward_without_drops(pair):
    """The port against itself: at capacity_factor = n_experts every
    group's capacity is G k, so neither pass drops a slot, and 64 decode
    steps equal a 64-token forward (mixtral's ring buffer has wrapped)."""
    _, (tc, tf, tp) = pair
    tc = dataclasses.replace(tc, capacity_factor=float(max(tc.n_experts, 1)))
    toks = _long(_tokens(tc, 2, 64, seed=3))
    full, _ = tf.forward(tc, tp, toks)
    cache = tf.init_cache(tc, 2, 64, device="cpu")
    for i in range(64):
        logits, cache = tf.decode_step(tc, tp, cache, toks[:, i:i + 1])
        torch.testing.assert_close(logits, full[:, i, : tc.vocab], **TOL)


def test_port_init_has_the_jax_tree_shapes_and_scales(pair):
    (jc, jf, jp), (tc, tf, _) = pair
    mine = tf.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(mine, transformer.TransformerLM)
    want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat = {}
    for name, p in mine.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":  # per-layer modules -> the stacked JAX leaf
            parts = ["blocks"] + parts[2:]
        flat.setdefault(tuple(parts), []).append(p.detach())
    assert len(flat) == len(want)
    for path, leaf in want.items():
        key = tuple(k.key for k in path)
        got = torch.stack(flat[key]) if key[0] == "blocks" else flat[key][0]
        assert tuple(got.shape) == leaf.shape, key
        np.testing.assert_allclose(float(got.std()), float(np.std(leaf)), rtol=0.25, atol=1e-6,
                                   err_msg=str(key))
    assert sum(p.numel() for p in mine.parameters()) == sum(a.size for a in jax.tree.leaves(jp))


# ---------------------------------------------------------------------------
# parameter counts and analytic FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_counts_and_model_flops_match_jax(reduced):
    assert arch_names() == jax_arch_names()
    assert SHAPES == {n: type(SHAPES[n])(*dataclasses.astuple(s)) for n, s in JAX_SHAPES.items()}
    for name in arch_names():
        mine, theirs = get_config(name, reduced), jax_config(name, reduced)
        assert mine.params_count() == theirs.params_count(), name
        assert roofline.active_params(mine) == jax_roofline.active_params(theirs), name
        for shape in SHAPES:
            assert (roofline.model_flops(mine, SHAPES[shape])
                    == jax_roofline.model_flops(theirs, JAX_SHAPES[shape])), (name, shape)
    moe_full = get_config("mixtral-8x22b")
    assert roofline.active_params(moe_full) < 0.4 * moe_full.params_count()
