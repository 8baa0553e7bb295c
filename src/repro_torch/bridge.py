"""Bridge the JAX package's parameters into the port's layout.

``from_jax_params(tree, cfg, device)`` takes the reference's params tree
with numpy leaves (for example ``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's tree: the same keys, with ``blocks``
unstacked from the reference's leading L axis into a list of per-layer
dicts.  Quantised leaves (objects with ``data``, ``scales``, ``bits`` and
``path``, as the reference's ``QuantizedTensor``) come across as the
port's ``QuantizedTensor``, each layer's slice of them.  This module
imports neither jax nor the reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.quant.quantize import QuantizedTensor


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_quantized(x) -> bool:
    return all(hasattr(x, a) for a in ("data", "scales", "bits", "path"))


def _convert(node, device, layer=None):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    if _is_quantized(node):
        data, scales = np.asarray(node.data), np.asarray(node.scales)
        if layer is not None:
            data, scales = data[layer], scales[layer]
        return QuantizedTensor(to_tensor(data, device), to_tensor(scales, device),
                               int(node.bits), str(node.path))
    a = np.asarray(node)
    return to_tensor(a[layer] if layer is not None else a, device)


def from_jax_params(tree: Any, cfg: ArchConfig, device) -> dict:
    """The reference's params (numpy leaves) as the port's params on
    ``device``."""
    out = {k: _convert(v, device) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_convert(tree["blocks"], device, i)
                     for i in range(cfg.n_layers)]
    return out
