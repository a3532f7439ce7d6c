"""Port vs reference: the roofline formulas (``launch/roofline.py``) and
the collectives' ring factors (``launch/collectives.py`` ``_link_bytes``).

``matmul_param_count``, ``model_flops``, ``attention_flops`` and
``analytic_hbm_traffic`` equal the reference's exactly for every arch x
shape at n_chips 1, 256 and 512 (and ``_cache_bytes``); ``_link_bytes``
equals ``repro/launch/hlo_analysis.py``'s for every kind and group size;
``terms`` divides by the H100 spec constants, and no TPU constant is
left in the port's module."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.collectives import _link_bytes  # noqa: E402

N_CHIPS = (1, 256, 512)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_formulas_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = SHAPES[shape], JSHAPES[shape]
    for active in (True, False):
        assert roofline.matmul_param_count(cfg, active) == jroof.matmul_param_count(jcfg, active)
    assert roofline.model_flops(cfg, s) == jroof.model_flops(jcfg, js)
    assert roofline.attention_flops(cfg, s) == jroof.attention_flops(jcfg, js)
    assert roofline._cache_bytes(cfg, s) == jroof._cache_bytes(jcfg, js)
    for n in N_CHIPS:
        assert roofline.analytic_hbm_traffic(cfg, s, n) == jroof.analytic_hbm_traffic(jcfg, js, n)
        assert (roofline.analytic_hbm_traffic(cfg, s, n, cache_bytes_global=1e9,
                                              param_bytes_global=3e9)
                == jroof.analytic_hbm_traffic(jcfg, js, n, cache_bytes_global=1e9,
                                              param_bytes_global=3e9))


@pytest.mark.parametrize("kind", KINDS)
def test_link_bytes_equal_reference(kind):
    for g in (1, 2, 4, 16, 32, 256, 512):
        for nbytes in (0, 1, 4096, 3 * 2**20 + 7, 2**40):
            assert _link_bytes(kind, nbytes, g) == jhlo._link_bytes(kind, nbytes, g)


def test_terms_use_the_h100_spec():
    assert roofline.H100 == dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                                 hbm_bytes=80e9)
    assert not [k for k in vars(roofline) if k.upper().startswith("V5")]
    cfg, s = get_config("granite-3-8b"), SHAPES["train_4k"]
    t = roofline.terms(cfg, s, 256, dot_flops=2e15, collective_link_bytes=9e9)
    assert t.compute_s == 2e15 / 989e12
    assert t.collective_s == 9e9 / 450e9
    assert t.memory_s == roofline.analytic_hbm_traffic(cfg, s, 256) / 3.35e12
    assert t.dominant == "compute"
