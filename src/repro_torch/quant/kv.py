"""Int8 KV-cache quantisation (per-token, per-head scales).

Port of ``repro.quant.kv``.  Each written K/V vector (head_dim values)
stores int8 codes plus one f32 scale, ``max|x| / 127 + 1e-12``; codes
round half to even (``torch.round``, as ``jnp.round``) and clip to
+-127, so they are bit-equal to the reference's.  Reads dequantise
``codes * scale`` in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv_write(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (codes int8 (..., hd), scales f32 (...))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """codes (..., hd) int8, scales (...) f32 -> (..., hd) dtype."""
    return (codes.float() * scales[..., None]).to(dtype)


def is_quantized_cache(cache) -> bool:
    return "k_scale" in cache
