"""The analog matmul's four routes: which calls each takes, how its launch
plan covers the problem, and that each route's call shapes compute the
reference's function.

On the CPU every route runs the plain version (``kernels/ref.py``), so the
parity tests here hold the plain version against the JAX reference at the
shapes, dtypes and flags each route takes on the card; ``chip_smoke.py``
and ``tests/test_torch_card.py`` hold the route's kernel against the plain
version there. Tolerance: the
reference's rule (``tests/test_kernels.py``), ``atol = 3e-5 * max|y|``,
widened to one output-quantizer bin under requant, ``rtol = 1e-4``. The
weight route's tensor-core form (noisy weights split into two bf16 parts)
and the simt route's (both operands split into two bf16 parts, three
products a step, the splits of K added in rank order) are held to the same
rule in plain PyTorch here, before the card runs them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core import SiteQuant as JSiteQuant  # noqa: E402
from repro.kernels import analog_matmul_reference as jreference  # noqa: E402
from repro.kernels.ref import analog_matmul_ref_raw as jref_raw  # noqa: E402
from repro.quant import calibrate_minmax  # noqa: E402
from repro_torch.core.analog import AnalogConfig, SiteQuant, key_seed  # noqa: E402
from repro_torch.kernels import analog_matmul as am  # noqa: E402
from repro_torch.kernels import ops, prng  # noqa: E402
from repro_torch.kernels.ref import _fake_quant, analog_matmul_ref_raw, seed_words  # noqa: E402
from repro_torch.core.noise import SHOT, NoiseSpec  # noqa: E402
from repro_torch.quant.affine import QuantParams  # noqa: E402
from repro_torch.quant.affine import calibrate_minmax as tcalibrate_minmax  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32

# (m, k, n, dtype, noise_kind, quant_x, quant_w, quant_out) -> route
ROUTE_TABLE = [
    ((1, 4096, 12800, BF16, "output", False, False, False), "decode"),
    ((1, 12800, 4096, BF16, "none", False, False, True), "decode"),
    ((1, 4096, 1024, BF16, "output", True, True, True), "decode"),
    ((am.M_DECODE, 4000, 1000, BF16, "output", False, False, False), "decode"),
    ((am.M_DECODE + 1, 4000, 1000, BF16, "output", False, False, False), "tc"),
    ((32, 4096, 12800, BF16, "output", False, False, False), "tc"),
    ((64, 4096, 1024, BF16, "none", False, False, True), "tc"),
    ((40, 4000, 1000, BF16, "output", False, False, True), "tc"),
    ((64, 4096, 1024, BF16, "output", True, False, False), "simt"),
    ((64, 4096, 1024, BF16, "output", False, True, False), "simt"),
    ((1, 4096, 12800, BF16, "weight", False, False, False), "weight"),
    ((64, 4096, 12800, BF16, "weight", False, False, False), "weight"),
    ((32, 4096, 1024, BF16, "weight", False, False, True), "weight"),
    ((am.M_DECODE, 4096, 1024, BF16, "weight", True, True, True), "weight"),
    ((512, 4000, 1000, BF16, "weight", False, False, False), "weight"),
    ((am.M_DECODE + 1, 4096, 1024, BF16, "weight", True, False, False), "simt"),
    ((64, 4096, 1024, BF16, "weight", False, True, True), "simt"),
    ((1, 4096, 12800, F32, "weight", False, False, False), "simt"),
    ((64, 4096, 1024, F32, "weight", False, False, True), "simt"),
    ((1, 4001, 1000, BF16, "weight", False, False, False), "simt"),
    ((64, 4096, 1001, BF16, "weight", False, False, False), "simt"),
    ((1, 4096, 12800, F32, "output", False, False, False), "simt"),
    ((64, 4096, 12800, F32, "none", False, False, False), "simt"),
    ((1, 4001, 1000, BF16, "output", False, False, False), "simt"),
    ((64, 4096, 1001, BF16, "output", False, False, False), "simt"),
]


@pytest.mark.parametrize("case,route", ROUTE_TABLE,
                         ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
@pytest.mark.parametrize("b", [1, 3, 16])
def test_select_route(case, route, b):
    m, k, n, dtype, kind, qx, qw, qo = case
    assert am.select_route(b, m, k, n, dtype, kind, qx, qw, qo) == route
    assert am.route_takes(route, m, k, n, dtype, kind, qx, qw)


def test_route_never_depends_on_batch():
    for m in (1, 2, am.M_DECODE, am.M_DECODE + 1, 32, 64, 512):
        for kind in ("output", "none", "weight"):
            for dtype in (BF16, F32):
                for flags in ((False, False, False), (True, False, True), (False, True, False)):
                    routes = {am.select_route(b, m, 4096, 1024, dtype, kind, *flags)
                              for b in range(1, 17)}
                    assert len(routes) == 1, (m, kind, dtype, flags, routes)


def test_route_takes_refuses():
    assert not am.route_takes("tc", 64, 4096, 1024, BF16, "output", True, False)
    assert not am.route_takes("tc", 64, 4096, 1024, BF16, "weight", False, False)
    assert not am.route_takes("decode", 1, 4096, 1024, F32, "output", False, False)
    assert not am.route_takes("decode", 1, 4096, 1020, BF16, "output", False, False)
    assert am.route_takes("decode", 64, 4096, 1024, BF16, "output", True, True)
    assert am.route_takes("simt", 1, 7, 5, F32, "weight", True, True)
    # weight: weight noise on bf16 rows of 16-byte multiples, input
    # quantizers only at up to M_DECODE rows a request
    assert am.route_takes("weight", 1, 4096, 1024, BF16, "weight", True, True)
    assert am.route_takes("weight", 512, 4096, 1024, BF16, "weight", False, False)
    assert not am.route_takes("weight", 1, 4096, 1024, BF16, "output", False, False)
    assert not am.route_takes("weight", 64, 4096, 1024, BF16, "none", False, False)
    assert not am.route_takes("weight", 1, 4096, 1024, F32, "weight", False, False)
    assert not am.route_takes("weight", 1, 4001, 1024, BF16, "weight", False, False)
    assert not am.route_takes("weight", 1, 4096, 1020, BF16, "weight", False, False)
    assert not am.route_takes("weight", am.M_DECODE + 1, 4096, 1024, BF16, "weight", True, False)
    assert not am.route_takes("weight", 64, 4096, 1024, BF16, "weight", False, True)
    assert not am.route_takes("decode", 1, 4096, 1024, BF16, "weight", False, False)


KN = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096), (4000, 1000), (16, 8),
      (8, 256), (40, 20 * 8), (100000, 8), (1000, 300000)]
#: the analog site shapes (K, N) of granite-3-8b, recurrentgemma-2b and
#: granite-20b
PLAN_SITES = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096),
              (2560, 2560), (2560, 256), (2560, 7680), (7680, 2560),
              (6144, 6144), (6144, 128), (6144, 24576), (24576, 6144)]
#: shared memory a block can take on the H100 (227 KB)
SMEM_MAX = 232448


def _check_split(ranges, k, step, min_rows):
    """The splits cover K exactly, in order, in whole ``step``-row granules
    (the last may end at a ragged K), each at least ``min_rows`` long but
    for a ragged last one, and fit one portable cluster."""
    assert len(ranges) in (1, 2, 4, 8)
    begin = 0
    for q, (b, e) in enumerate(ranges):
        assert b == begin and b % step == 0 and e > b
        assert e % step == 0 or e == k
        if len(ranges) > 1:
            assert e - b > min_rows - step if q == len(ranges) - 1 else e - b >= min_rows
        begin = e
    assert begin == k


def _decode_ranges(plan, k):
    return [(q * plan["kc"], min(k, (q + 1) * plan["kc"])) for q in range(plan["splits"])]


def _tc_ranges(plan, k):
    return am.split_ranges(plan["k_tiles"], plan["splits"], am.TC_BK, k)


def _decode_smem(plan):
    """The decode block's shared memory: its x slice as f32, a room that
    later takes the k lanes' reduction (8 lanes x 4 rows x 32 threads'
    columns)."""
    return max(plan["kc"] * plan["rt"] * 4, 8 * 4 * plan["cpt"] * 32 * 4)


@pytest.mark.parametrize("rows", [1, 4, 16])
@pytest.mark.parametrize("k,n", KN, ids=lambda v: str(v))
def test_decode_plan_covers_k_and_n(k, n, rows):
    plan = am.decode_plan(k, n, rows)
    kc, splits, tiles = plan["kc"], plan["splits"], plan["col_tiles"]
    assert kc % am.DECODE_STEP == 0 and 0 < kc <= am.DECODE_KC_MAX
    assert (splits - 1) * kc < k <= splits * kc  # every split non-empty, K covered
    width = 32 * plan["cpt"]
    assert (tiles - 1) * width < n <= tiles * width
    covered = np.zeros(k, np.int64)
    for s in range(splits):
        covered[s * kc: min(k, (s + 1) * kc)] += 1
    assert (covered == 1).all()
    assert _decode_smem(plan) <= SMEM_MAX


@pytest.mark.parametrize("rows,k,n", [(256, 4096, 12800), (120, 4000, 1000), (128, 8, 8),
                                      (129, 12800, 4096), (5, 40, 136)])
def test_tc_plan_covers(rows, k, n):
    plan = am.tc_plan(rows, k, n)
    assert (plan["grid_m"] - 1) * am.TC_BM < rows <= plan["grid_m"] * am.TC_BM
    assert (plan["grid_n"] - 1) * am.TC_BN < n <= plan["grid_n"] * am.TC_BN
    assert (plan["k_tiles"] - 1) * am.TC_BK < k <= plan["k_tiles"] * am.TC_BK


@pytest.mark.parametrize("rows", [1, 64, 256, 300])
@pytest.mark.parametrize("k,n", KN, ids=lambda v: str(v))
def test_tc_plan_splits_k_into_a_cluster(k, n, rows):
    """The tc route's splits cover K in whole 64-deep tiles, at least
    ``TC_MIN_SPLIT`` a split, in one portable cluster (1, 2, 4 or 8), and
    the block's shared memory fits the H100."""
    plan = am.tc_plan(rows, k, n)
    _check_split(_tc_ranges(plan, k), k, am.TC_BK, am.TC_MIN_SPLIT * am.TC_BK)
    assert plan["smem"] <= SMEM_MAX


@pytest.mark.parametrize("k,n", KN, ids=lambda v: str(v))
def test_decode_split_never_depends_on_rows(k, n):
    """The order of every output's sum is fixed by the split of K: it must
    be the same for a request alone as in any batch."""
    splits = {(p["kc"], p["splits"]) for p in (am.decode_plan(k, n, r) for r in range(1, 301))}
    assert len(splits) == 1


@pytest.mark.parametrize("k,n", KN, ids=lambda v: str(v))
def test_tc_split_never_depends_on_rows(k, n):
    plans = {(p["k_tiles"], p["splits"], p["grid_n"])
             for p in (am.tc_plan(r, k, n) for r in range(1, 301))}
    assert len(plans) == 1


def _simt_ranges(plan, k):
    return am.split_ranges(plan["k_steps"], plan["splits"], am.SIMT_BK, k)


#: ResNet-50's conv sites as (rows at batch 16, K, N): conv1, a 56x56 3x3,
#: a 28x28 expand, the 7x7 stage's 3x3, the fc
CONV_SITES = [(200704, 147, 64), (50176, 576, 64), (12544, 128, 512), (784, 4608, 512),
              (16, 2048, 1000)]


@pytest.mark.parametrize("rows", [1, 16, 784, 200704, 65535 * 64 + 64, 2**31 - 1])
@pytest.mark.parametrize("k,n", KN + [(147, 64), (4608, 512), (2048, 1000)],
                         ids=lambda v: str(v))
def test_simt_plan_covers(k, n, rows):
    """The simt route's tiles cover the rows (above the old grid's 65,535
    row tiles too), the columns and K; its splits cover K in whole 32-deep
    steps, at least ``SIMT_MIN_SPLIT`` a split, in one portable cluster;
    two blocks fit a SM."""
    plan = am.simt_plan(rows, k, n)
    assert (plan["row_tiles"] - 1) * am.SIMT_BM < rows <= plan["row_tiles"] * am.SIMT_BM
    assert (plan["col_tiles"] - 1) * am.SIMT_BN < n <= plan["col_tiles"] * am.SIMT_BN
    assert (plan["k_steps"] - 1) * am.SIMT_BK < k <= plan["k_steps"] * am.SIMT_BK
    _check_split(_simt_ranges(plan, k), k, am.SIMT_BK, am.SIMT_MIN_SPLIT * am.SIMT_BK)
    assert 2 * (plan["smem"] + 1024) <= 233472  # the H100's 228 KB a SM, 1 KB reserved a block


@pytest.mark.parametrize("k,n", KN + [(147, 64), (4608, 512), (2048, 1000)],
                         ids=lambda v: str(v))
def test_simt_split_never_depends_on_rows(k, n):
    plans = {(p["k_steps"], p["splits"], p["col_tiles"])
             for p in (am.simt_plan(r, k, n) for r in [*range(1, 301), 200704, 2**31 - 1])}
    assert len(plans) == 1


def test_simt_plan_fills_the_card_at_resnet_sites():
    """Small-row sites split K for blocks: the 7x7 stage's 3x3 (784 rows,
    7 row tiles x 8 column tiles) in 8 splits, the fc (16 rows, 16 column
    tiles) in 4; conv1's K = 147 (5 steps) is not split."""
    splits = {(k, n): am.simt_plan(rows, k, n)["splits"] for rows, k, n in CONV_SITES}
    assert splits[(4608, 512)] == 8 and splits[(2048, 1000)] == 4
    assert splits[(147, 64)] == 1


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("k,n", PLAN_SITES, ids=lambda v: str(v))
def test_shard_plan_splits_k_as_the_whole(k, n, tp):
    """A column shard (``plan_n`` = N, N / tp columns) takes the whole
    call's split of K, so it sums in the whole call's order."""
    for rows in (1, 4, 16):
        whole, shard = am.decode_plan(k, n, rows), am.decode_plan(k, n // tp, rows, plan_n=n)
        assert _decode_ranges(shard, k) == _decode_ranges(whole, k)
    for rows in (64, 256):
        whole, shard = am.tc_plan(rows, k, n), am.tc_plan(rows, k, n // tp, plan_n=n)
        assert _tc_ranges(shard, k) == _tc_ranges(whole, k)
    for rows in (9, 784, 200704):
        whole, shard = am.simt_plan(rows, k, n), am.simt_plan(rows, k, n // tp, plan_n=n)
        assert _simt_ranges(shard, k) == _simt_ranges(whole, k)


def test_decode_plan_fills_the_card_at_granite_sites():
    """decode: at least 3 blocks for each of the H100's 132 SMs at every
    granite-3-8b site (k/v is held to 512 by the 32-row granule of a
    split). tc, at every site of granite-3-8b, recurrentgemma-2b and
    granite-20b: the splits are the least power of two up to 8 that give
    64 blocks at one row tile (so the two row tiles of a served prefill run
    about a block a SM), unless a split would fall below ``TC_MIN_SPLIT``
    K tiles. granite-3-8b k/v (4096 -> 1024): tc 8 column tiles x 8 splits
    of 8 K tiles, against 8 blocks unsplit."""
    for k, n in KN[:4]:
        plan = am.decode_plan(k, n, 4)
        assert plan["splits"] * plan["col_tiles"] >= 3 * 132, (k, n, plan)
    for k, n in PLAN_SITES:
        t = am.tc_plan(256, k, n)
        tiles, splits, units = t["grid_n"], t["splits"], t["k_tiles"]
        assert splits in (1, 2, 4, 8)
        assert (tiles * splits >= am.TC_BLOCKS or splits == 8
                or units < 2 * splits * am.TC_MIN_SPLIT), (k, n)
        assert splits == 1 or (tiles * splits // 2 < am.TC_BLOCKS
                               and units >= splits * am.TC_MIN_SPLIT), (k, n)
    kv = am.tc_plan(256, 4096, 1024)
    assert (kv["grid_n"], kv["splits"], kv["k_tiles"] // kv["splits"]) == (8, 8, 8)


@pytest.mark.parametrize("rows", [1, 3, 4, 5, 8, 9, 16, 17, 64, 16 * am.M_DECODE])
def test_decode_rows_cover(rows):
    plan = am.decode_plan(4096, 1024, rows)
    rt, groups = plan["rt"], plan["row_groups"]
    assert rt in (4, 8, 16) and plan["cpt"] in (4, 8)
    assert (groups - 1) * rt < rows <= groups * rt


@pytest.mark.parametrize("rows", [1, am.M_DECODE, am.M_DECODE + 1, 32, 64, 65, 100])
@pytest.mark.parametrize("k,n", KN, ids=lambda v: str(v))
def test_weight_plan_covers_k_and_n(k, n, rows):
    plan = am.weight_plan(k, n, rows)
    kc, splits, tiles = plan["kc"], plan["splits"], plan["col_tiles"]
    assert kc % am.WEIGHT_STEP == 0 and 0 < kc <= am.WEIGHT_KC_MAX
    assert (splits - 1) * kc < k <= splits * kc  # every split non-empty, K covered
    assert (tiles - 1) * am.WEIGHT_BN < n <= tiles * am.WEIGHT_BN
    if rows <= am.M_DECODE:
        assert plan["row_tiles"] == 0  # the decode kernel: all of a request's rows a block
    else:
        assert (plan["row_tiles"] - 1) * am.WEIGHT_BM < rows <= plan["row_tiles"] * am.WEIGHT_BM
    covered = np.zeros(k, np.int64)
    for s in range(splits):
        covered[s * kc: min(k, (s + 1) * kc)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("k,n", KN, ids=lambda v: str(v))
def test_weight_split_never_depends_on_rows(k, n):
    """The order of every output's sum is fixed by the split of K and the
    column tiles: the same for any row count, so for a request alone as in
    any batch (the plan never sees B)."""
    plans = {(p["kc"], p["splits"], p["col_tiles"])
             for p in (am.weight_plan(k, n, r) for r in range(1, 200))}
    assert len(plans) == 1


def test_weight_plan_fills_two_waves_at_granite_sites():
    """At least two waves (4 blocks of 128 threads on each of the H100's
    132 SMs) for one request at every granite-3-8b site, decode and
    prefill."""
    assert am.WEIGHT_TARGET_BLOCKS == 2 * 4 * 132
    for k, n in KN[:4]:
        for rows in (1, 32, 64):
            plan = am.weight_plan(k, n, rows)
            assert plan["splits"] * plan["col_tiles"] >= 2 * am.WEIGHT_WAVE, (k, n, rows, plan)


def _raw(b, m, k, n, dtype=F32):
    return [torch.zeros(b, m, k, dtype=dtype), torch.zeros(k, n, dtype=dtype),
            torch.ones(b, m, 1), torch.ones(1, 1, n), torch.ones(3, n), torch.ones(1, 8),
            torch.zeros(b, 4, dtype=torch.int32)]


@pytest.mark.parametrize("route,kw", [
    ("tc", dict(noise_kind="weight")),
    ("tc", dict(quant_x=True)),
    ("decode", dict()),  # f32 operands
    ("weight", dict(noise_kind="weight")),  # f32 operands
    ("weight", dict()),  # output noise
    ("warp", dict()),
])
def test_forced_route_refuses_what_it_does_not_compute(route, kw):
    with pytest.raises(ValueError):
        am.analog_matmul_raw(*_raw(2, 3, 16, 8), route=route, **kw)


# ---------------------------------------------------------------------------
# each route's call shapes against the JAX reference (plain version on CPU)
# ---------------------------------------------------------------------------

ROUTE_CASES = {
    "decode": (3, 1, 64, 40),
    "tc": (3, 9, 64, 40),
    "simt": (2, 9, 36, 20),
    "weight": (3, 9, 64, 40),
}


def _bf16_data(b, m, k, n, seed):
    """numpy inputs already on the bf16 grid, so both packages see the same
    numbers whether they hold them in bf16 or f32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, m, k)).astype(np.float32)).to(BF16)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.2).astype(np.float32)).to(BF16)
    return x.float().numpy(), w.float().numpy()


def _configs(route, requant):
    if route in ("simt", "weight"):
        return JAnalogConfig.weight(0.1), AnalogConfig.weight(0.1), 5.0
    if requant:
        kw = dict(weight_bits=None, act_bits=None)
        return JAnalogConfig.thermal(0.01, **kw), AnalogConfig.thermal(0.01, **kw), 4.0
    return JAnalogConfig.shot(), AnalogConfig.shot(), 10.0


@pytest.mark.parametrize("requant", [False, True], ids=["float", "requant"])
@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_route_call_matches_reference(route, n_repeats, requant):
    """The batched call a route takes on the card, every request against
    the reference's solo call with its own key."""
    b, m, k, n = ROUTE_CASES[route]
    x, w = _bf16_data(b, m, k, n, seed=5)
    jcfg, cfg, e = _configs(route, requant)
    jsq = sq = None
    if requant:
        jsq = JSiteQuant(oqp=calibrate_minmax(jnp.asarray(x) @ jnp.asarray(w)))
        sq = SiteQuant(oqp=QuantParams(torch.from_numpy(np.array(jsq.oqp.x_min)),
                                       torch.from_numpy(np.array(jsq.oqp.x_max)), jsq.oqp.bits))
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), u) for u in range(b)]
    seed = key_seed(np.asarray(jnp.stack(keys)), "cpu")
    dtype = F32 if route == "simt" else BF16  # simt: f32 operands, as the reference's
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    o = ops.prepare_operands(xt, wt, energy=torch.tensor(e), seed=seed, cfg=cfg, sq=sq)
    if route == "weight":  # bf16 operands, the col scale of the f32 ranges (ROADMAP C)
        o["col_scale"] = ops.prepare_operands(
            torch.from_numpy(x), torch.from_numpy(w), energy=torch.tensor(e), seed=seed,
            cfg=cfg, sq=sq)["col_scale"]
    assert am.select_route(b, m, k, n, dtype, o["noise_kind"], o["quant_x"], o["quant_w"],
                           o["quant_out"]) == route
    got = am.analog_matmul_raw(
        o["x"], o["w"], o["row_scale"], o["col_scale"], o["wq"], o["scalars"], o["seed"],
        noise_kind=o["noise_kind"], quant_x=o["quant_x"], quant_w=o["quant_w"],
        quant_out=o["quant_out"], n_repeats=n_repeats, route=route,
    ).numpy()
    for i in range(b):
        want = np.asarray(jreference(
            jnp.asarray(x[i]), jnp.asarray(w), energy=jnp.asarray(e), key=keys[i],
            cfg=jcfg, sq=jsq, n_repeats=n_repeats,
        ))
        atol = 3e-5 * (float(np.abs(want).max()) + 1e-6)
        if requant:
            atol = max(atol, float(jsq.oqp.delta) * 1.01)
        np.testing.assert_allclose(got[i], want, atol=atol, rtol=1e-4)


# ---------------------------------------------------------------------------
# the weight route's tensor-core form, in plain PyTorch
# ---------------------------------------------------------------------------


def _weight_split_product(x, w, col_scale, seed, n_repeats):
    """What the weight route's prefill kernel computes, in plain PyTorch:
    v = w + cs * xi in f32, as the reference forms it, split into hi =
    bf16(v) and lo = bf16(v - hi) (round to nearest even, as the kernel's
    conversion), and x @ hi + x @ lo in f32 (bf16 x bf16 products are exact
    in f32; the kernel adds both into one accumulator, in its own order)."""
    k, n = w.shape
    k0, k1, _, col0 = seed_words(seed)
    xi = prng.repeat_averaged_gaussian_tile(
        k0 ^ prng.WEIGHT_STREAM_SALT, k1, 0, col0, (k, n), n_repeats)
    v = w.float() + col_scale * xi
    hi = v.to(BF16).float()
    lo = (v - hi).to(BF16).float()
    return torch.matmul(x.float(), hi) + torch.matmul(x.float(), lo)


@pytest.mark.parametrize("per_request_cs", [False, True], ids=["shared-cs", "per-request-cs"])
@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("shape", [(2, 8, 12800, 64), (3, 9, 520, 40)], ids=str)
def test_weight_split_keeps_the_function(shape, n_repeats, per_request_cs):
    """Two bf16 parts keep each noisy weight to about 2^-17 of itself: the
    split product stays within the reference's rule (``3e-5 * max|y|``,
    ``rtol = 1e-4``) of the plain version and of the JAX reference's raw
    function, request by request, at K = 12800 (granite-3-8b's down)."""
    b, m, k, n = shape
    x, w = _bf16_data(b, m, k, n, seed=11)
    keys = [jax.random.fold_in(jax.random.PRNGKey(4), u) for u in range(b)]
    seed = key_seed(np.asarray(jnp.stack(keys)), "cpu")
    o = ops.prepare_operands(torch.from_numpy(x), torch.from_numpy(w), energy=torch.tensor(5.0),
                             seed=seed, cfg=AnalogConfig.weight(0.1))
    cs = o["col_scale"]
    if per_request_cs:
        cs = cs * (1.0 + torch.arange(b, dtype=F32).reshape(b, 1, 1) / 4)
    xb, wb = torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16)
    got = _weight_split_product(xb, wb, cs, o["seed"], n_repeats).numpy()
    plain = analog_matmul_ref_raw(xb, wb, o["row_scale"], cs, o["wq"], o["scalars"], o["seed"],
                                  noise_kind="weight", n_repeats=n_repeats).numpy()
    seeds = o["seed"].numpy().view(np.uint32)
    for i in range(b):
        want = np.asarray(jref_raw(
            jnp.asarray(x[i]), jnp.asarray(w), jnp.ones((m, 1), jnp.float32),
            jnp.asarray(cs[i if per_request_cs else 0].numpy()), jnp.ones((3, n), jnp.float32),
            jnp.asarray(o["scalars"].numpy()), jnp.asarray(seeds[i:i + 1]),
            noise_kind="weight", n_repeats=n_repeats,
        ))
        for ref in (want, plain[i]):
            atol = 3e-5 * (float(np.abs(ref).max()) + 1e-6)
            np.testing.assert_allclose(got[i], ref, atol=atol, rtol=1e-4)


# ---------------------------------------------------------------------------
# the simt route's tensor-core form, in plain PyTorch
# ---------------------------------------------------------------------------


def _parts(v):
    """hi = bf16(v) and lo = bf16(v - hi), round to nearest even, as the
    kernel's conversion; bf16 x bf16 products are exact in f32."""
    hi = v.to(BF16).float()
    return hi, (v - hi).to(BF16).float()


def _simt_split_product(o, n_repeats, plan_n=None):
    """What the simt kernel computes, in plain PyTorch: x and w after their
    quantizers and the weight noise (f32, as the reference forms them), each
    split into hi and lo bf16 parts; in each split of K (``simt_plan``) the
    16-deep steps in K order, each adding hi*hi, then hi*lo, then lo*hi to one
    f32 accumulator; the splits added in rank order; then the plain
    version's epilogue (its noise term alone, from x = 0, and the output
    quantizer). Elementwise in the rows: a row's sum never depends on the
    other rows."""
    x, w = o["x"].float(), o["w"].float()
    b, m, k = x.shape
    n = w.shape[1]
    sc = o["scalars"].reshape(-1)
    if o["quant_x"]:
        x = _fake_quant(x, sc[0], sc[1], sc[2])
    if o["quant_w"]:
        w = _fake_quant(w, o["wq"][0:1], o["wq"][1:2], o["wq"][2:3])
    weight = o["noise_kind"] == "weight"
    if weight:
        k0, k1, _, col0 = seed_words(o["seed"])
        xi = prng.repeat_averaged_gaussian_tile(
            k0 ^ prng.WEIGHT_STREAM_SALT, k1, 0, col0, (k, n), n_repeats)
        w = w + o["col_scale"].float() * xi  # (B, K, N)
    (xh, xl), (wh, wl) = _parts(x), _parts(w)
    plan = am.simt_plan(m if weight else b * m, k, n, plan_n)
    y = None
    for begin, end in _simt_ranges(plan, k):
        acc = torch.zeros((b, m, n))
        for k16 in range(begin, end, 16):
            s = slice(k16, min(k16 + 16, end))
            acc = acc + torch.matmul(xh[..., s], wh[..., s, :])
            acc = acc + torch.matmul(xh[..., s], wl[..., s, :])
            acc = acc + torch.matmul(xl[..., s], wh[..., s, :])
        y = acc if y is None else y + acc
    if o["noise_kind"] == "output":
        y = y + analog_matmul_ref_raw(torch.zeros_like(o["x"]), o["w"], o["row_scale"],
                                      o["col_scale"], o["wq"], o["scalars"], o["seed"],
                                      n_repeats=n_repeats)
    if o["quant_out"]:
        y = _fake_quant(y, sc[3], sc[4], sc[5])
    return y, plan["splits"]


#: (name, (B, M, K, N), operand type, config) of calls the simt route takes:
#: ResNet-50's conv1 (K = 147) and a 3x3 site (K = 1152: 2 splits) in f32
#: under shot noise, the odd widths of the card's simt case under weight
#: noise, bf16 with the input quantizers above ``M_DECODE`` rows, weight
#: noise with them
SIMT_MODEL_CASES = [
    ("conv1", (1, 96, 147, 64), F32, "shot"),
    ("3x3 K=1152", (1, 24, 1152, 128), F32, "shot"),
    ("odd widths", (2, 9, 36, 20), BF16, "weight"),
    ("bf16 quant_x", (2, 9, 64, 40), BF16, "quant"),
    ("weight+quant_x", (2, 9, 64, 40), BF16, "weight+quant"),
]


@pytest.mark.parametrize("requant", [False, True], ids=["float", "requant"])
@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("name,shape,dtype,kind", SIMT_MODEL_CASES,
                         ids=[c[0] for c in SIMT_MODEL_CASES])
def test_simt_split_parts_keep_the_function(name, shape, dtype, kind, n_repeats, requant):
    """Split bf16 parts keep each operand to about 2^-17 of itself and drop
    only lo*lo: summed in the kernel's order, the product stays within the
    reference's rule (``3e-5 * max|y|``, ``rtol = 1e-4``, one output bin
    under requant) of the plain version and of the JAX reference's raw
    function, request by request; the last request alone is its rows of
    the batch, bit for bit."""
    b, m, k, n = shape
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((b, m, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)).to(dtype)
    cfg = {"shot": AnalogConfig(mode="analog", noise=NoiseSpec(kind=SHOT)),
           "quant": AnalogConfig.thermal(0.01), "weight": AnalogConfig.weight(0.1),
           "weight+quant": AnalogConfig.weight(0.1)}[kind]
    xf, wf = x.float(), w.float()
    oqp = tcalibrate_minmax(torch.matmul(xf, wf)) if requant else None
    sq = SiteQuant(oqp=oqp) if requant else None
    if kind.endswith("quant"):
        sq = SiteQuant(wqp=tcalibrate_minmax(wf, channel_axis=1), xqp=tcalibrate_minmax(xf),
                       oqp=oqp)
    keys = [jax.random.fold_in(jax.random.PRNGKey(8), u) for u in range(b)]
    seed = key_seed(np.asarray(jnp.stack(keys)), "cpu")
    o = ops.prepare_operands(x, w, energy=torch.tensor(5.0 if "weight" in kind else 20.0),
                             seed=seed, cfg=cfg, sq=sq)
    assert am.select_route(b, m, k, n, dtype, o["noise_kind"], o["quant_x"], o["quant_w"],
                           o["quant_out"]) == "simt"
    assert o["quant_out"] == requant and o["quant_x"] == kind.endswith("quant")
    got, splits = _simt_split_product(o, n_repeats)
    assert splits == (2 if k == 1152 else 1)
    kw = dict(noise_kind=o["noise_kind"], quant_x=o["quant_x"], quant_w=o["quant_w"],
              quant_out=o["quant_out"], n_repeats=n_repeats)
    args = [o[t] for t in ("x", "w", "row_scale", "col_scale", "wq", "scalars", "seed")]
    plain = analog_matmul_ref_raw(*args, **kw).numpy()
    seeds = o["seed"].numpy().view(np.uint32)
    bins = 0.0
    if requant:
        bins = float(o["scalars"].reshape(-1)[3]) * 1.01
    for i in range(b):
        want = np.asarray(jref_raw(
            jnp.asarray(xf[i].numpy()), jnp.asarray(wf.numpy()),
            jnp.asarray(o["row_scale"][i].numpy()),
            jnp.asarray(o["col_scale"][i % o["col_scale"].shape[0]].numpy()),
            jnp.asarray(o["wq"].numpy()), jnp.asarray(o["scalars"].numpy()),
            jnp.asarray(seeds[i:i + 1]), **kw))
        for ref in (want, plain[i]):
            atol = max(3e-5 * (float(np.abs(ref).max()) + 1e-6), bins)
            np.testing.assert_allclose(got[i].numpy(), ref, atol=atol, rtol=1e-4)
    i = b - 1  # the last request alone: its rows of the batch
    solo = {t: o[t][i:i + 1] for t in ("x", "row_scale", "seed")}
    solo["col_scale"] = o["col_scale"][i % o["col_scale"].shape[0]][None]
    alone, _ = _simt_split_product(dict(o, **solo), n_repeats)
    assert torch.equal(alone[0], got[i])


# ---------------------------------------------------------------------------
# the decode and tc routes' split of K, in plain PyTorch
# ---------------------------------------------------------------------------


def _split_sum(x, w, ranges, lanes, groups):
    """The order in which the decode (``lanes`` = 8, ``groups`` = 8) and tc
    (1, 1) routes sum each output, in f32 PyTorch: in each split of K,
    ``lanes`` chains, chain l adding the products of rows l, l + lanes, ...
    in K order, the chains added in order; then the splits: group g adds
    splits g, g + groups, ... in order, and the groups are added in order
    (the decode route's second pass; one group is rank order). Elementwise,
    so a row's sum never depends on the other rows."""
    x, w = x.float(), w.float()
    parts = []
    for b, e in ranges:
        steps = -(-(e - b) // lanes)
        pad = steps * lanes - (e - b)
        xs = torch.nn.functional.pad(x[..., b:e], (0, pad)).reshape(*x.shape[:-1], steps, lanes)
        ws = torch.nn.functional.pad(w[b:e], (0, 0, 0, pad)).reshape(steps, lanes, w.shape[1])
        acc = torch.zeros((lanes, *x.shape[:-1], w.shape[1]))
        for j in range(steps):
            acc = acc + xs[..., j, :].movedim(-1, 0)[..., None] * ws[j][:, None, None, :]
        part = acc[0]
        for lane in range(1, lanes):
            part = part + acc[lane]
        parts.append(part)
    total = None
    for g in range(min(groups, len(parts))):
        group = parts[g]
        for q in range(g + groups, len(parts), groups):
            group = group + parts[q]
        total = group if total is None else total + group
    return total


def _split_emulation(route, o, n_repeats):
    """What the route computes: the split sum, then the plain version's
    epilogue (its noise term alone, from x = 0, and the output quantizer)."""
    b, m, k = o["x"].shape
    n = o["w"].shape[1]
    if route == "decode":
        ranges, lanes, groups = _decode_ranges(am.decode_plan(k, n, b * m), k), 8, 8
    else:
        ranges, lanes, groups = _tc_ranges(am.tc_plan(b * m, k, n), k), 1, 1
    y = _split_sum(o["x"], o["w"], ranges, lanes, groups)
    noise = analog_matmul_ref_raw(torch.zeros_like(o["x"]), o["w"], o["row_scale"], o["col_scale"],
                                  o["wq"], o["scalars"], o["seed"], noise_kind=o["noise_kind"],
                                  n_repeats=n_repeats)
    y = y + noise
    if o["quant_out"]:
        sc = o["scalars"].reshape(-1)
        y = torch.clamp(torch.round(y / sc[3]) + sc[4], 0.0, float(sc[5]))
        y = (y - sc[4]) * sc[3]
    return y, len(ranges)


@pytest.mark.parametrize("n_repeats,requant", [(1, False), (4, True)], ids=["K1", "K4-requant"])
@pytest.mark.parametrize("shape", [(2, 1, 4096, 1024), (3, 2, 4000, 1000), (2, 9, 4096, 1024),
                                   (3, 40, 4000, 1000)], ids=str)
def test_split_sum_keeps_the_function(shape, n_repeats, requant):
    """The decode route (M = 1, 2; 125-128 splits of 32 rows) and the tc
    route (M = 9, 40; granite k/v 4096 -> 1024 in 8 splits) at granite k/v
    and a ragged shape: summed per split and the splits added in the
    route's order, the result is within the reference's
    rule (``3e-5 * max|y|``, ``rtol = 1e-4``, one output bin under
    requant) of the plain version, request by request, and of the JAX
    reference's raw function (request 0); and the last request alone is
    its rows of the batch, bit for bit."""
    b, m, k, n = shape
    route = "decode" if m <= am.M_DECODE else "tc"
    x, w = _bf16_data(b, m, k, n, seed=12)
    jcfg, cfg, e = _configs(route, requant)
    jsq = sq = None
    if requant:
        jsq = JSiteQuant(oqp=calibrate_minmax(jnp.asarray(x) @ jnp.asarray(w)))
        sq = SiteQuant(oqp=QuantParams(torch.from_numpy(np.array(jsq.oqp.x_min)),
                                       torch.from_numpy(np.array(jsq.oqp.x_max)), jsq.oqp.bits))
    keys = [jax.random.fold_in(jax.random.PRNGKey(6), u) for u in range(b)]
    seed = key_seed(np.asarray(jnp.stack(keys)), "cpu")
    o = ops.prepare_operands(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                             energy=torch.tensor(e), seed=seed, cfg=cfg, sq=sq)
    assert am.select_route(b, m, k, n, BF16, o["noise_kind"], o["quant_x"], o["quant_w"],
                           o["quant_out"]) == route
    got, splits = _split_emulation(route, o, n_repeats)
    assert splits == (128 if route == "decode" else 8) if k == 4096 else splits > 1
    plain = analog_matmul_ref_raw(
        o["x"], o["w"], o["row_scale"], o["col_scale"], o["wq"], o["scalars"], o["seed"],
        noise_kind=o["noise_kind"], quant_out=o["quant_out"], n_repeats=n_repeats).numpy()
    seeds = o["seed"].numpy().view(np.uint32)
    want = np.asarray(jref_raw(  # request 0 (the plain version is held to it elsewhere)
        jnp.asarray(x[0]), jnp.asarray(w), jnp.asarray(o["row_scale"][0].numpy()),
        jnp.asarray(o["col_scale"][0].numpy()), jnp.asarray(o["wq"].numpy()),
        jnp.asarray(o["scalars"].numpy()), jnp.asarray(seeds[:1]),
        noise_kind=o["noise_kind"], quant_out=o["quant_out"], n_repeats=n_repeats,
    ))
    for i, ref in [(0, want)] + list(enumerate(plain)):
        atol = 3e-5 * (float(np.abs(ref).max()) + 1e-6)
        if requant:
            atol = max(atol, float(jsq.oqp.delta) * 1.01)
        np.testing.assert_allclose(got[i].numpy(), ref, atol=atol, rtol=1e-4)
    i = b - 1  # the last request alone: its rows of the batch
    solo = {t: o[t][i:i + 1] for t in ("x", "row_scale", "seed")}
    solo["col_scale"] = o["col_scale"][i % o["col_scale"].shape[0]][None]
    alone, _ = _split_emulation(route, dict(o, **solo), n_repeats)
    assert torch.equal(alone[0], got[i])
