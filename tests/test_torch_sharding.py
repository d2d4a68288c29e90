"""The port's partition specs against the JAX package's.

Every family's ``param_pspecs``, ``batch_pspecs`` (every ``SHAPES`` kind)
and ``input_specs``, and ``zero1_pspecs`` / ``opt_state_pspecs``, on the
meshes (2, 4) ("data", "model"), (2, 2, 2) ("pod", "data", "model") and
(1, 1), given as fake meshes (only ``shape`` is read), as
``tests/test_optim_data_serve.py`` does.  The configurations are the
published ones: the specs read n_kv_heads, n_experts, n_patches and the
layer count, never a weight.

The port keeps a list of per-layer trees where the JAX package stacks
each layer leaf along a leading axis, so a port layer's spec is the JAX
leaf's spec without its leading entry (``models/convert.py`` maps the
leaves the same way); every other spec is equal as it stands.  Input
specs: the meta tensors' shapes and dtypes against the
``ShapeDtypeStruct``s.  ZeRO-1: the port's rule on its per-layer leaves
against the JAX package's ``zero1_pspecs`` on the same specs and shapes
(the per-layer shapes from ``jax.eval_shape`` of the JAX init), and
against it directly on the unstacked leaves.

The helpers of ``launch/sharding.py`` that need no ranks are here too:
``local_shard`` on a fake rank.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import optim as joptim
from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro.models.api import SHAPES as JAX_SHAPES
from repro_torch import optim
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.sharding import P, flatten, local_shard, tree_map
from repro_torch.models import get_family
from repro_torch.models.api import SHAPES

MESHES = {
    "2x4": {"data": 2, "model": 4},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
    "1x1": {"data": 1, "model": 1},
}
LAYER_KEYS = ("blocks", "enc_blocks", "dec_blocks")


class FakeMesh:
    def __init__(self, shape, rank=0):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank

    def coords(self, rank=None):
        rank = self.rank if rank is None else rank
        out = {}
        for ax in reversed(self.axis_names):
            rank, out[ax] = divmod(rank, self.shape[ax])
        return {ax: out[ax] for ax in self.axis_names}

    def axis_size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes, rank=None):
        c, idx = self.coords(rank), 0
        for ax in axes:
            idx = idx * self.shape[ax] + c[ax]
        return idx


def _is_jspec(x):
    return isinstance(x, JP) or x is None


def _jtuple(tree, drop_first=False):
    """A JAX spec tree as nested dicts of tuples (a layer leaf's leading
    entry dropped)."""
    if isinstance(tree, dict):
        return {k: _jtuple(v, drop_first) for k, v in tree.items()}
    t = tuple(tree)
    return t[1:] if drop_first else t


def _jax_as_port(cfg, jtree):
    """The JAX package's param spec tree in the port's layout."""
    out = {}
    for k, v in jtree.items():
        if k in LAYER_KEYS:
            n = cfg.n_enc_layers if k == "enc_blocks" else cfg.n_layers
            out[k] = [_jtuple(v, drop_first=True) for _ in range(n)]
        else:
            out[k] = _jtuple(v)
    return out


def _port_tuple(tree):
    return tree_map(tuple, tree)


def _configs(name):
    return jax_config(name), get_config(name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_pspecs_equal_jax(name, mesh):
    jc, tc = _configs(name)
    m = FakeMesh(MESHES[mesh])
    want = _jax_as_port(jc, jax_family(jc).param_pspecs(jc, m))
    got = get_family(tc).param_pspecs(tc, m)
    assert _port_tuple(got) == want
    assert all(isinstance(s, P) for s in flatten(got).values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_batch_pspecs_equal_jax(name, shape, mesh):
    jc, tc = _configs(name)
    m = FakeMesh(MESHES[mesh])
    want = jax.tree.map(tuple, jax_family(jc).batch_pspecs(jc, JAX_SHAPES[shape], m),
                        is_leaf=_is_jspec)
    assert _port_tuple(get_family(tc).batch_pspecs(tc, SHAPES[shape], m)) == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_jax(name, shape):
    jc, tc = _configs(name)
    want = jax_family(jc).input_specs(jc, JAX_SHAPES[shape])
    got = get_family(tc).input_specs(tc, SHAPES[shape])
    flat_want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    flat_got = flatten(got)
    assert set(flat_got) == {k.replace("/", ".") for k in flat_want}
    for k, leaf in flat_want.items():
        t = flat_got[k.replace("/", ".")]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(leaf.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), k


# ---------------------------------------------------------------------------
# ZeRO-1 and the optimizer state
# ---------------------------------------------------------------------------


def _shapes(jc):
    """The JAX parameter shapes (abstract init) and the port's per-layer
    shapes, flattened by the port's parameter names."""
    jshapes = jax.eval_shape(lambda k: jax_family(jc).init(jc, k), jax.random.PRNGKey(0))
    out = {}
    for k, v in jshapes.items():
        if k in LAYER_KEYS:
            n = jc.n_enc_layers if k == "enc_blocks" else jc.n_layers
            per = jax.tree.map(lambda s: tuple(s.shape[1:]), v)
            out[k] = [per for _ in range(n)]
        else:
            out[k] = jax.tree.map(lambda s: tuple(s.shape), v)
    return jshapes, out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_zero1_pspecs_equal_jax(name, mesh):
    jc, tc = _configs(name)
    m = FakeMesh(MESHES[mesh])
    jshapes, shapes = _shapes(jc)
    specs = get_family(tc).param_pspecs(tc, m)
    got = flatten(optim.zero1_pspecs(specs, shapes, m))
    flat_specs, flat_shapes = flatten(specs), flatten(shapes)
    jflat = {n: JP(*s) for n, s in flat_specs.items()}
    sds = {n: jax.ShapeDtypeStruct(s, np.float32) for n, s in flat_shapes.items()}
    want = joptim.zero1_pspecs(jflat, sds, m)
    assert {n: tuple(s) for n, s in got.items()} == {n: tuple(s) for n, s in want.items()}
    # the leaves without a layer axis: the JAX package's own tree
    jwhole = joptim.zero1_pspecs(jax_family(jc).param_pspecs(jc, m), jshapes, m)
    for k in jwhole:
        if k not in LAYER_KEYS:
            assert _port_tuple(optim.zero1_pspecs(specs[k], shapes[k], m)) == _jtuple(jwhole[k])


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "zamba2-2.7b"])
def test_opt_state_pspecs_equal_jax(name, zero1):
    jc, tc = _configs(name)
    m = FakeMesh(MESHES["2x4"])
    _, shapes = _shapes(jc)
    specs = get_family(tc).param_pspecs(tc, m)
    got = optim.opt_state_pspecs(specs, shapes, m, zero1=zero1, master_weights=True)
    flat_specs, flat_shapes = flatten(specs), flatten(shapes)
    want = joptim.opt_state_pspecs({n: JP(*s) for n, s in flat_specs.items()},
                                   {n: jax.ShapeDtypeStruct(s, np.float32)
                                    for n, s in flat_shapes.items()}, m, zero1=zero1,
                                   master_weights=True)
    assert tuple(got.step) == tuple(want.step) == ()
    for field in ("m", "v", "master"):
        assert ({n: tuple(s) for n, s in flatten(getattr(got, field)).items()}
                == {n: tuple(s) for n, s in getattr(want, field).items()})


def test_zero1_pspecs_shards_divisible_dims():
    """``tests/test_optim_data_serve.py``'s case on the port."""
    m = FakeMesh({"data": 4, "model": 2})
    pspecs = {"a": P(None, "model"), "b": P("model", None)}
    params = {"a": torch.zeros((8, 6)), "b": torch.zeros((3, 5))}
    out = optim.zero1_pspecs(pspecs, params, m)
    assert out["a"] == P("data", "model")
    assert out["b"] == P("model", None)


# ---------------------------------------------------------------------------
# local_shard (no ranks needed)
# ---------------------------------------------------------------------------


def test_local_shard_takes_each_ranks_block():
    t = torch.arange(8 * 12).reshape(8, 12)
    shape = {"pod": 2, "data": 2, "model": 3}
    blocks = {}
    for r in range(12):
        mesh = FakeMesh(shape, rank=r)
        blocks[r] = local_shard(t, P(("pod", "data"), "model"), mesh)
        c = mesh.coords()
        i = c["pod"] * 2 + c["data"]
        assert torch.equal(blocks[r], t[2 * i:2 * i + 2, 4 * c["model"]:4 * c["model"] + 4])
    # segments: each rank's share of every segment, in turn
    w = torch.arange(10.0)[None].repeat(2, 1)
    seg = local_shard(w, P(None, "model"), FakeMesh({"model": 2}, rank=1), {1: [4, 6]})
    assert seg[0].tolist() == [2.0, 3.0, 7.0, 8.0, 9.0]
    with pytest.raises(ValueError):
        local_shard(w, P(None, "model"), FakeMesh({"model": 3}), {1: [4, 6]})

