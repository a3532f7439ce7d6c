"""The analog matmul's routes on the card: each route's kernel against the
plain version (``kernels/ref.py``) on the same inputs, a request's rows the
same bits alone as in a batch, and the same bits from launch to launch.

Needs an NVIDIA card and no JAX (the machine with the card has none):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Without a card every test here skips. Tolerance: the reference's rule
(``tests/test_kernels.py``), ``atol = 3e-5 * max|y|``, ``rtol = 1e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.kernels import analog_matmul as am  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: (B, M, K, N) of a call each route takes
ROUTE_CASES = {
    "decode": (3, 1, 64, 40),
    "tc": (3, 9, 64, 40),
    "simt": (2, 9, 36, 20),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the route kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_route_kernel_matches_plain_on_card(route, cuda_device):
    b, m, k, n = ROUTE_CASES[route]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((b, m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.2).astype(np.float32))
    cfg, e = (AnalogConfig.weight(0.1), 5.0) if route == "simt" else (AnalogConfig.shot(), 10.0)
    seed = torch.from_numpy(np.arange(4 * b, dtype=np.int32).reshape(b, 4))
    o = ops.prepare_operands(x.to(torch.bfloat16).to(cuda_device),
                             w.to(torch.bfloat16).to(cuda_device),
                             energy=torch.tensor(e), seed=seed, cfg=cfg)
    args = [o[t] for t in ("x", "w", "row_scale", "col_scale", "wq", "scalars", "seed")]
    before = am.LAUNCHES[route]
    got = am.analog_matmul_raw(*args, noise_kind=o["noise_kind"], n_repeats=4, route=route)
    want = ops.analog_matmul_ref_raw(*args, noise_kind=o["noise_kind"], n_repeats=4)
    assert am.LAUNCHES[route] == before + 1
    atol = 3e-5 * (float(want.abs().max()) + 1e-6)
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-4)
    assert torch.equal(got, am.analog_matmul_raw(*args, noise_kind=o["noise_kind"], n_repeats=4,
                                                 route=route))
    for i in range(b):
        solo = [args[0][i:i + 1], args[1], args[2][i:i + 1], args[3][:1], args[4], args[5],
                args[6][i:i + 1]]
        if args[3].shape[0] == b:
            solo[3] = args[3][i:i + 1]
        y = am.analog_matmul_raw(*solo, noise_kind=o["noise_kind"], n_repeats=4, route=route)
        assert torch.equal(y[0], got[i])
