"""The port stands alone and runs on the card unless asked otherwise.

* Importing every ``repro_torch`` module loads no ``jax*`` and no ``repro.*``
  module, and ``chip_smoke.py`` imports neither.
* Entry points default to ``device="cuda"``: on a machine without a card
  they raise instead of running on the CPU, and ``chip_smoke.py`` exits
  non-zero without printing a result.
* The kernel wrapper has no ``try`` that could fall back to the plain path.
"""
import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs as several processes on the cores (pytest-xdist): torch's
# intra-op threads in each would oversubscribe them (20x slower when six run)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN or top.startswith("jax")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(len(mods))\n"
        "print(','.join(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')"
        " or n.startswith('jax'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, loaded = out.stdout.strip().splitlines() + [""] * (2 - len(out.stdout.strip().splitlines()))
    assert int(n_mods) >= 20
    assert loaded == "", f"port imported {loaded}"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_chip_smoke_and_port_sources_import_no_jax_and_no_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_kernel_wrapper_has_no_fallback():
    path = os.path.join(SRC, "repro_torch", "kernels", "analog_matmul.py")
    tree = ast.parse(open(path).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")


@pytest.mark.parametrize("entry", ["engine", "init_params", "init_energy_tree", "analog_matmul",
                                   "bridge"])
def test_default_device_raises_without_a_card(entry):
    _no_card()
    from repro_torch import bridge
    from repro_torch.configs.granite_3_8b import smoke_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine

    cfg = smoke_config()
    calls = {
        "engine": lambda: ServingEngine({}, cfg),
        "init_params": lambda: lm.init_params(cfg),
        "init_energy_tree": lambda: lm.init_energy_tree(cfg, 1.0),
        "analog_matmul": lambda: ops.analog_matmul(
            torch.ones(2, 4), torch.ones(4, 3), energy=torch.tensor(1.0),
            seed=torch.zeros(4, dtype=torch.int32), cfg=AnalogConfig.shot()),
        "bridge": lambda: bridge.energies_from_numpy({"groups": {}, "lm_head": 1.0}, cfg),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def _run_smoke(cwd, script):
    return subprocess.run([sys.executable, script], capture_output=True, text=True, cwd=cwd,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = _run_smoke(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
