"""Config registry: 10 assigned architectures + the paper's 3 GQA models.

``get_config(name)`` accepts the assignment ids (e.g. "qwen2-moe-a2.7b").
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, shape_applicable  # noqa: F401

from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4_scout
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4_mini
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25_3b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.paper_models import LLAMA31_8B, MISTRAL_7B, QWEN25_7B

ASSIGNED: List[ArchConfig] = [
    _qwen2_moe, _llama4_scout, _mamba2, _phi4_mini, _olmo,
    _internlm2, _qwen25_3b, _qwen2_vl, _musicgen, _zamba2,
]

PAPER_MODELS: List[ArchConfig] = [QWEN25_7B, MISTRAL_7B, LLAMA31_8B]

_REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in ASSIGNED + PAPER_MODELS}


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs(assigned_only: bool = False) -> List[str]:
    return [c.name for c in (ASSIGNED if assigned_only else ASSIGNED + PAPER_MODELS)]
