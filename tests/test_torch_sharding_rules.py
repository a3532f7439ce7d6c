"""Port vs reference: the logical-axis rules of ``models/sharding.py``
(``spec``, ``tree_shardings``, ``zero1_axes``, the rule tables) and
``lm.param_axes``.

* The reference's eight cases (``tests/test_sharding_rules.py``) on the
  port's ``spec`` with a (data=16, model=16) mesh.
* The port's ``spec`` on its own ``Mesh`` against the reference's on a
  duck-typed mesh of the same sizes, for every leaf of ``param_axes`` of
  every family's smoke config and of its ``zero1_axes``, under the
  config's training profile and the other one, at (data, model) in
  (2, 1), (4, 1), (16, 16); ``tree_shardings`` over the whole tree.
* ``param_axes`` equals the reference's for every config.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import sharding as jsharding
from repro_torch.configs import EXTRA_ARCHS, get_smoke_config, list_archs
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.models import lm
from repro_torch.models.sharding import (
    DEFAULT_RULES,
    DP_RULES,
    PROFILES,
    SERVING_RULES,
    spec,
    tree_shardings,
    use_rules,
    zero1_axes,
)
from repro_torch.tree import leaves, map_leaves

ARCHS = list_archs() + list(EXTRA_ARCHS)
MESHES = [(2, 1), (4, 1), (16, 16)]


class FakeMesh:
    """The reference's duck-typed mesh (its tests' ``FakeMesh``) of (data,
    model) sizes."""

    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.devices = type("_Dev", (), {"shape": (data, model)})()
        self.size = data * model


MESH = make_mesh_for_devices(16, data=16)


def _spec(names, shape, rules=DEFAULT_RULES):
    return spec(names, rules=rules, mesh=MESH, shape=shape)


def test_divisible_dims_shard():
    assert _spec((None, "mlp"), (4096, 12800)) == (None, "model")
    assert _spec(("vocab", None), (49168, 4096)) == ("model", None)


def test_non_divisible_dims_fall_back_to_replicated():
    assert _spec(("vocab", None), (92553, 2048)) == (None, None)


def test_conflict_resolution_first_dim_wins():
    s = _spec(("layers", "experts", "expert_embed", "expert_mlp"), (24, 128, 5120, 8192))
    assert s == (None, "data", None, "model")


def test_grok_virtual_expert_fallback():
    s = _spec(("layers", "experts", "expert_embed", "expert_mlp"), (64, 8, 6144, 32768))
    assert s == (None, None, "data", "model")


def test_tuple_axes_degrade_to_prefix():
    assert _spec(("batch", None), (8, 128)) == (None, None)
    assert _spec(("batch", None), (256, 128)) == ("data", None)


def test_dp_rules_put_everything_on_batch():
    assert _spec(("batch", None, None), (256, 4096, 2048), rules=DP_RULES) == (
        ("data", "model"), None, None)
    assert _spec((None, "mlp"), (2048, 8192), rules=DP_RULES) == (None, None)


def test_zero1_axes_targets_first_replicated_dim():
    assert zero1_axes(("layers", None, "mlp")) == ("layers", "zero", "mlp")
    assert zero1_axes(("vocab", None)) == ("vocab", "zero")
    assert zero1_axes(("layers", "experts", "expert_embed", "expert_mlp")) == (
        "layers", "experts", "expert_embed", "expert_mlp")


def test_without_shape_no_filtering():
    assert spec(("vocab",), rules=DEFAULT_RULES, mesh=MESH) == ("model",)


def test_rule_tables_equal_the_reference():
    assert DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert DP_RULES == jsharding.DP_RULES
    assert SERVING_RULES == jsharding.SERVING_RULES
    assert set(PROFILES) == set(jsharding.PROFILES)
    with use_rules(DP_RULES):
        assert spec(("batch",), mesh=MESH, shape=(256,)) == (("data", "model"),)
    assert spec(("batch",), mesh=MESH, shape=(256,)) == ("data",)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_reference(arch):
    want = jax.tree.leaves(jlm.param_axes(jsmoke(arch)), is_leaf=lambda x: isinstance(x, tuple))
    assert leaves(lm.param_axes(get_smoke_config(arch))) == want


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_equals_the_reference_on_every_leaf(arch, data, model):
    cfg = get_smoke_config(arch)
    mesh, fake = make_mesh_for_devices(model, data=data), FakeMesh(data, model)
    shapes = map_leaves(lambda _p, leaf: leaf.shape, lm.param_leaves(cfg))
    axes = lm.param_axes(cfg)
    for profile in ("tp", "dp"):
        rules = PROFILES[profile]
        for names, shape in zip(leaves(axes), leaves(shapes)):
            for ax in (names, zero1_axes(names)):
                want = jsharding.spec(ax, rules=jsharding.PROFILES[profile], mesh=fake,
                                      shape=shape)
                assert P(*spec(ax, rules, mesh, shape)) == want, (profile, ax, shape)
        placed = tree_shardings(axes, shapes, mesh, rules)
        assert leaves(placed) == [spec(a, rules, mesh, s)
                                  for a, s in zip(leaves(axes), leaves(shapes))]
