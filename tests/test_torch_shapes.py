"""Port vs reference: the shape set (``configs/shapes.py``): ``SHAPES``
and ``ShapeSpec`` field for field, ``shape_applicable`` (verdict and
reason) and ``input_specs`` (keys, shapes, dtypes; meta tensors, no
storage) for every arch x shape."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, reduced_depth, shape_applicable  # noqa: E402,E501

DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def test_shape_set_equals_reference():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (j.name, j.seq_len,
                                                               j.global_batch, j.kind)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_applicable_and_input_specs_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert shape_applicable(cfg, SHAPES[shape]) == jshape_applicable(jcfg, JSHAPES[shape])
    got, want = input_specs(cfg, SHAPES[shape]), jinput_specs(jcfg, JSHAPES[shape])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), (k, t.shape, want[k].shape)
        assert jnp.dtype(DTYPES[t.dtype]) == jnp.dtype(want[k].dtype), (k, t.dtype)


def test_reduced_depth_still_importable_from_configs():
    cfg = reduced_depth(get_config("granite-3-8b"), n_layers=2)
    assert cfg.n_layers == 2
