"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), each
with a plain PyTorch version beside it in ``ref.py``."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.kernels._build import SOURCES


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's ``launches`` counter, by kernel name."""
    return {name: importlib.import_module(f"repro_torch.kernels.{name}.ops").launches
            for name in SOURCES}
