"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and its entry points run on the card
unless the caller names the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    # the solver, the models (MoE included), serving with its governor,
    # telemetry, the load generator and the launcher
    assert n_modules >= 67
    for name in ("models.moe", "telemetry.bus", "telemetry.sinks",
                 "serving.governor", "loadgen.traces", "loadgen.driver",
                 "launch.serve"):
        assert (PORT / (name.replace(".", "/") + ".py")).is_file(), name


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_sources_name_no_jax_import(where):
    files = (sorted(PORT.rglob("*.py")) if where == "package"
             else [ROOT / "chip_smoke.py"])
    assert files
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


def test_no_card_means_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.core import network, profiles
    from repro_torch.launch.platform import resolve_device
    from repro_torch.serving.cluster import SplitInferenceCluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    prof = profiles.get_profile("nin", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitInferenceCluster(None, None, prof)
    cfg = network.small_config(n_users=4, n_subchannels=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network.make_scenario(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiles.get_profile("nin")
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import transformer
    mcfg = get_tiny_config("recurrentgemma-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init(torch.Generator().manual_seed(0), mcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiles.transformer_profile(mcfg, seq=8)
    model = transformer.init(torch.Generator().manual_seed(0), mcfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitInferenceCluster(model, mcfg, prof)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Alone in a directory (and, here, without a card) the script exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_describe_records_platform():
    from repro_torch.launch import platform
    d = platform.describe()
    for key in ("torch", "cuda", "device_count", "device_name",
                "matmul_allow_tf32", "cudnn_allow_tf32",
                "float32_matmul_precision", "nvidia_smi"):
        assert key in d
    assert d["matmul_allow_tf32"] is False
    assert d["cudnn_allow_tf32"] is False
    assert d["float32_matmul_precision"] == "highest"
