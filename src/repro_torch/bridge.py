"""Bridge the JAX package's parameters into the port's layout, and back.

``from_jax_params(tree, cfg, device)`` takes the reference's params tree
with numpy leaves (for example ``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's tree: the same keys, with ``blocks``
unstacked from the reference's leading L axis into a list of per-layer
dicts.  Quantised leaves (objects with ``data``, ``scales``, ``bits`` and
``path``, as the reference's ``QuantizedTensor``) come across as the
port's ``QuantizedTensor``, each layer's slice of them.
``from_jax_opt_state`` does the same for the reference's AdamW state
(its ``mu`` and ``nu`` are trees like the params).

``to_reference_layout(tree, cfg)`` is the reverse for plain tensors: the
port's params (or grads, or moments) as numpy arrays under the
reference's keys, ``blocks`` stacked on a leading L axis again, so that
tests compare the two packages leaf by leaf.  A bf16 leaf comes back as
its raw bits (``np.uint16``): numpy has no bf16 of its own.  This module
imports neither jax, nor ml_dtypes, nor the reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.quant.quantize import QuantizedTensor
from repro_torch.training.optimizer import AdamWState


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


def from_jax_opt_state(state: Any, cfg: ArchConfig, device) -> AdamWState:
    """The reference's ``AdamWState`` (``step``, ``mu``, ``nu``; numpy
    leaves) as the port's, on ``device``."""
    return AdamWState(to_tensor(state.step, device),
                      from_jax_params(state.mu, cfg, device),
                      from_jax_params(state.nu, cfg, device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as its raw bits
    (``np.uint16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stack(node):
    """Per-layer nodes (dicts of tensors, or tensors) stacked leaf by
    leaf on a new leading axis."""
    if isinstance(node[0], dict):
        return {k: _stack([n[k] for n in node]) for k in node[0]}
    if node[0] is None:
        return None
    return np.stack([to_numpy(t) for t in node])


def to_reference_layout(tree: Any, cfg: ArchConfig) -> dict:
    """The port's params-shaped tree (params, grads or moments) as the
    reference's: numpy leaves, ``blocks`` stacked on a leading L axis of
    ``cfg.n_layers``."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return None if node is None else to_numpy(node)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['blocks'])} blocks for {cfg.n_layers} layers")
    out = {k: convert(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = _stack(tree["blocks"])
    return out
