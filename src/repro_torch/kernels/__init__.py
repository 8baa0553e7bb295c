"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), each
with a plain PyTorch version beside it in ``ref.py``."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.kernels._build import SOURCES

# kernel name -> (the module under kernels/ whose ops.py counts it, the
# counter's name there): one forward kernel per source, and RMSNorm's
# backward beside its forward
COUNTERS: Dict[str, Tuple[str, str]] = {
    **{name: (name, "launches") for name in SOURCES},
    "rmsnorm_bwd": ("rmsnorm", "bwd_launches"),
}


def _ops(module: str):
    return importlib.import_module(f"repro_torch.kernels.{module}.ops")


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel name."""
    return {name: getattr(_ops(module), attr)
            for name, (module, attr) in COUNTERS.items()}


def zero_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for module, attr in COUNTERS.values():
        setattr(_ops(module), attr, 0)
