"""The port stands alone: no import of jax or of the JAX package, entry
points that run on CUDA unless the CPU is asked for, and a CPU smoke of
the serve CLI."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_serve_module_loads_without_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.bridge; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    subprocess.run([sys.executable, "-c", code], env=ENV, check=True, timeout=120)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("qwen2.5-3b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg, device="cuda")
    Model(cfg, device="cpu")


def test_serve_cli_cpu_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b",
         "--reduced", "--device", "cpu", "--prompt-len", "8", "--new-tokens", "6",
         "--timed"],
        env=ENV, check=True, timeout=120, capture_output=True, text=True).stdout
    assert "generated (1, 6) tokens on cpu" in out
    assert "p50 step" in out and "first tokens:" in out
