"""Import hygiene of the port, and its refusal to drop to the CPU.

A fresh interpreter imports every ``repro_torch`` module, the port's
examples (``examples/torch_*.py``) and ``chip_smoke.py`` (whose top-level
imports are the script's whole dependency list) and must end with no
``jax*`` and no ``repro.*`` module loaded: the card's machine has no JAX.  Entry points given no device and
no CUDA raise instead of running on the CPU.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pathlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401  (runs nothing at import)
for path in sorted(pathlib.Path(sys.argv[1], "examples").glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "LEAKED:" if bad else "clean", " ".join(bad))
print(" ".join(names))
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout
    # the new modules and both examples were among those imported
    for name in ("repro_torch.kernels.collectives.ops",
                 "repro_torch.kernels.ssd.ops", "repro_torch.models.ssd",
                 "repro_torch.kernels.rg_lru.ops", "repro_torch.models.rglru",
                 "repro_torch.core.flatten", "repro_torch.core.serialization",
                 "repro_torch.core.shard",
                 "torch_quickstart.py", "torch_sample_sort.py"):
        assert name in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import KampingError
    from repro_torch.launch.serve import main
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-9b"):
        cfg = get_config(arch, smoke=True)
        with pytest.raises(KampingError, match="device='cpu'"):
            init_params(cfg)
        params = init_params(cfg, device="cpu")
        with pytest.raises(KampingError, match="device='cpu'"):
            ServeEngine(cfg, params, max_len=16, num_slots=1)
        with pytest.raises((KampingError, RuntimeError, AssertionError)):
            main(["--arch", arch, "--smoke"])  # --device cuda default
