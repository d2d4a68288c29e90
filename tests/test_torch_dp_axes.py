"""The port's mesh helpers of the model API (``dp_axes``, ``dp_axes_for``,
``supports_shape`` in ``repro_torch.models.api``) against the JAX
package's, for every workload shape and every architecture, on mesh
stand-ins: objects with the ``shape`` mapping both read, for the meshes
(1,) ("data"), (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data",
"model"), and one with no data axis at all.  Exact equality."""

import types

import pytest

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api

MESHES = {
    "data1": {"data": 1},
    "pod2x4": {"data": 2, "model": 4},
    "multipod2x2x2": {"pod": 2, "data": 2, "model": 2},
    "model4": {"model": 4},
}


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def test_the_port_has_the_same_shapes():
    assert set(api.SHAPES) == set(japi.SHAPES)
    for name, s in api.SHAPES.items():
        j = japi.SHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == (j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("mesh", MESHES)
def test_dp_axes_matches_jax(mesh):
    assert api.dp_axes(_mesh(mesh)) == japi.dp_axes(_mesh(mesh))


@pytest.mark.parametrize("shape", sorted(api.SHAPES))
@pytest.mark.parametrize("mesh", MESHES)
def test_dp_axes_for_matches_jax(mesh, shape):
    batch = api.SHAPES[shape].global_batch
    for b in (batch, 1, 3, 8):
        assert api.dp_axes_for(_mesh(mesh), b) == japi.dp_axes_for(_mesh(mesh), b)


@pytest.mark.parametrize("shape", sorted(api.SHAPES))
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_supports_shape_matches_jax(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert api.supports_shape(cfg, api.SHAPES[shape]) == japi.supports_shape(
        jcfg, japi.SHAPES[shape])
