"""Quantisation paths (paper §7): bf16 / int8 / int4, dequant vs fused."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.quant.paths import matmul, weight_bytes_streamed  # noqa: F401
from repro_torch.quant.quantize import (DEFAULT_GROUP, QuantizedTensor,  # noqa: F401
                                        dequantize, quantize, unpack_int4)

# weight leaf names eligible for quantisation (embeddings, norms, biases,
# routers, convs and SSM scalars stay in the model dtype — standard practice)
QUANTIZABLE = {"wq", "wk", "wv", "wo", "gate", "up", "down",
               "w_gate", "w_up", "w_down", "in_proj", "out_proj"}

WEIGHT_PATHS = ("bf16", "int8_dequant", "int8_fused", "int4_dequant", "int4_fused")


def parse_path(path: str):
    """'int4_fused' -> (4, 'fused'); 'bf16' -> None."""
    if path == "bf16":
        return None
    bits_s, mode = path.split("_")
    return int(bits_s[3:]), mode


def quantize_tree(params: Any, path: str, group: int = DEFAULT_GROUP) -> Any:
    """A copy of the params tree (dicts and lists) with eligible linear
    weights replaced by QuantizedTensor leaves, quantised on their
    device."""
    spec = parse_path(path)
    if spec is None:
        return params
    bits, mode = spec

    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, name) for v in node]
        if not isinstance(node, torch.Tensor) or node.dim() < 2 \
                or name not in QUANTIZABLE:
            return node
        k = node.shape[-2]
        g = min(group, k)
        if (bits == 4 and k % 2) or k % g:
            return node
        return quantize(node, bits, g, mode)

    return visit(params)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    elif node is not None:
        yield node


def tree_weight_traffic(params: Any) -> float:
    """Total per-step analytic weight HBM traffic (bytes) for a params
    tree under its current quant layout (floor-model numerator)."""
    return float(sum(weight_bytes_streamed(leaf) for leaf in _leaves(params)))
