"""The port's AdamW and int8 gradient compression against the JAX
package's.

AdamW against ``repro.optim.apply_updates`` on the same numpy parameters
and gradients over 20 steps that cross the warmup into the cosine:
clipped and unclipped, with and without weight decay, and with float32
master weights over bfloat16 parameters.  ``schedule`` and
``global_norm``; ``compress`` / ``compress_tree`` with error feedback,
exact half-way ties included; and the ports of the JAX package's unit
tests (convergence on a quadratic, ``grad_norm`` reported unclipped).

Tolerances: parameters and moments within 1e-6 of their largest
magnitude (the same float32 formula; the port's schedule and bias
corrections are computed on the host in float64, the JAX package's in
float32: the differences seen are < 2e-7); bfloat16 parameters (master
weights) exactly.  Compression: ``q`` and the scale equal, the error
within 1e-7 of the largest gradient magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim

CASES = {
    "clipped_decay": dict(clip_norm=1.0, weight_decay=0.1),
    "unclipped_no_decay": dict(clip_norm=100.0, weight_decay=0.0),
    "master_bf16": dict(clip_norm=1.0, weight_decay=0.1, master_weights=True),
}


def _params(rng):
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)},
            "d": rng.standard_normal((3, 2, 4)).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _close(want, got, tol=1e-6):
    want, got = np.asarray(want, dtype=np.float32), np.asarray(got, dtype=np.float32)
    assert float(np.abs(want - got).max()) <= tol * max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_matches_jax_over_20_steps(case):
    kw = CASES[case]
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=20, **kw)
    tcfg = optim.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=20, **kw)
    master = kw.get("master_weights", False)
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if master else (jnp.float32, torch.float32)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in _flat(p0).items()}
    js = jopt.init(jp, master_weights=master)
    tp = {k: torch.tensor(v).to(tdt) for k, v in _flat(p0).items()}
    ts = optim.init(tp, master_weights=master)
    for _ in range(20):
        g = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
             for k, v in _flat(p0).items()}
        jp, js, jm = jopt.apply_updates(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tm = optim.apply_updates(tcfg, tp, {k: torch.tensor(v) for k, v in g.items()}, ts)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert ts.step == int(js.step) == 20
    for k in tp:
        assert tp[k].dtype == tdt
        if master:
            np.testing.assert_array_equal(np.asarray(jp[k].astype(jnp.float32)),
                                          tp[k].float().numpy())
            _close(js.master[k], ts.master[k].numpy())
        else:
            _close(jp[k], tp[k].numpy())
        _close(js.m[k], ts.m[k].numpy())
        _close(js.v[k], ts.v[k].numpy())


def test_adamw_updates_in_foreach_groups_as_in_one():
    """The update over several foreach groups equals the update over one."""
    rng = np.random.default_rng(1)
    p0 = _flat(_params(rng))
    g = {k: torch.tensor(rng.standard_normal(v.shape).astype(np.float32)) for k, v in p0.items()}
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=0)
    out = []
    for limit in (optim.adamw.GROUP_ELEMENTS, 20):
        old = optim.adamw.GROUP_ELEMENTS
        optim.adamw.GROUP_ELEMENTS = limit
        try:
            p = {k: torch.tensor(v) for k, v in p0.items()}
            optim.apply_updates(cfg, p, g, optim.init(p))
        finally:
            optim.adamw.GROUP_ELEMENTS = old
        out.append(p)
    assert len(optim.adamw._groups(list(g.values()))) == 1
    for k in p0:
        torch.testing.assert_close(out[0][k], out[1][k], rtol=0, atol=0)


@pytest.mark.parametrize("step", [0, 10, 100])
def test_schedule_matches_jax(step):
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
               dict(lr=3e-4, warmup_steps=0, total_steps=50)):
        want = float(jopt.schedule(jopt.AdamWConfig(**kw), jnp.asarray(step)))
        assert optim.schedule(optim.AdamWConfig(**kw), step) == pytest.approx(want, rel=1e-6,
                                                                              abs=1e-12)


def test_schedule_warmup_and_cosine():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert optim.schedule(cfg, 0) == 0.0
    assert optim.schedule(cfg, 10) == pytest.approx(1.0)
    assert optim.schedule(cfg, 100) == pytest.approx(0.1)


def test_global_norm_matches_jax():
    tree = _flat(_params(np.random.default_rng(2)))
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = optim.global_norm({k: torch.tensor(v) for k, v in tree.items()})
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(optim.global_norm([torch.tensor(v).bfloat16() for v in tree.values()])) == \
        pytest.approx(want, rel=1e-2)


def test_adamw_converges_on_quadratic():
    cfg = optim.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0,
                            clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = optim.init(params)
    for _ in range(200):
        optim.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)  # d/dw ||w||^2
    assert float(params["w"].abs().max()) < 0.05


def test_clip_norm_applied():
    cfg = optim.AdamWConfig(lr=0.0, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    m = optim.apply_updates(cfg, params, {"w": torch.full((4,), 100.0)}, optim.init(params))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


def test_compress_rounds_half_to_even_as_jax():
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 0.0], dtype=np.float32)
    err = np.zeros_like(g)
    jq, js, je = jopt.compress.compress(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = optim.compress.compress(torch.tensor(g), torch.tensor(err))
    assert float(ts) == float(js) == 1.0
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy(), [127, 0, 2, 2, 0, -2, 4, -126, 0])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    torch.testing.assert_close(optim.compress.decompress(tq, ts),
                               torch.tensor(np.asarray(jopt.compress.decompress(jq, js))))


def test_compress_tree_with_error_feedback_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"a": (6, 9), "b": (33,), "c": (2, 3, 4)}
    jerr = jopt.compress.init_error_state({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = optim.compress.init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * rng.uniform(0.01, 10)).astype(np.float32)
             for k, s in shapes.items()}
        jhat, jerr = jopt.compress.compress_tree({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        that, terr = optim.compress.compress_tree({k: torch.tensor(v) for k, v in g.items()},
                                                  terr)
        for k in shapes:
            scale = float(np.abs(g[k]).max())
            np.testing.assert_allclose(that[k].numpy(), np.asarray(jhat[k]), rtol=0,
                                       atol=1e-7 * scale)
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]), rtol=0,
                                       atol=1e-7 * scale)
    for k in shapes:  # the quantized values themselves
        q_t, s_t, _ = optim.compress.compress(torch.tensor(g[k]), terr[k])
        q_j, s_j, _ = jopt.compress.compress(jnp.asarray(g[k]), jerr[k])
        assert float(s_t) == float(s_j)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))


def test_compress_tree_shares_a_scale_across_the_layers_of_one_jax_leaf():
    """The port keeps one tensor a layer where the JAX package stacks the
    layers into one leaf: the layers of one parameter share the leaf's
    scale, so the round trip equals the JAX package's on the stacked leaf."""
    rng = np.random.default_rng(4)
    layers = [(rng.standard_normal((4, 6)) * (i + 1)).astype(np.float32) for i in range(3)]
    head = rng.standard_normal(5).astype(np.float32)
    stacked = {"blocks": {"attn": {"wq": np.stack(layers)}}, "head": head}
    jhat, jerr = jopt.compress.compress_tree(
        {"blocks": {"attn": {"wq": jnp.asarray(stacked["blocks"]["attn"]["wq"])}},
         "head": jnp.asarray(head)},
        jopt.compress.init_error_state(stacked))
    grads = {f"blocks.{i}.attn.wq": torch.tensor(x) for i, x in enumerate(layers)}
    grads["head"] = torch.tensor(head)
    that, terr = optim.compress.compress_tree(grads, optim.compress.init_error_state(grads))
    assert optim.compress.leaf_key("blocks.12.attn.wq") == "blocks.attn.wq"
    for i in range(3):
        np.testing.assert_array_equal(that[f"blocks.{i}.attn.wq"].numpy(),
                                      np.asarray(jhat["blocks"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(terr[f"blocks.{i}.attn.wq"].numpy(),
                                      np.asarray(jerr["blocks"]["attn"]["wq"][i]))
    np.testing.assert_array_equal(that["head"].numpy(), np.asarray(jhat["head"]))
