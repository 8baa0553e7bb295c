"""The single matmul entry point all models route linear layers through.

Plain tensors take ``x @ w``; ``QuantizedTensor`` weights dispatch on
their ``path``:

  dequant — materialise the weight in x's dtype, then matmul (traffic
            >= W_bf16: the trap)
  fused   — 2-D int4 weights go through the int4 kernel
            (kernels/int4_matmul: the card launches it, a CPU tensor
            takes its plain version); other fused weights multiply a
            bf16 dequantisation, as the reference does off its TPU.
"""
from __future__ import annotations

import torch

from repro_torch.quant.quantize import QuantizedTensor, dequantize


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w (K, N) with quant-path dispatch."""
    if isinstance(w, QuantizedTensor):
        if w.path == "dequant":
            return x @ dequantize(w, x.dtype)
        if w.bits == 4 and w.ndim == 2:
            from repro_torch.kernels.int4_matmul import ops as int4_ops
            lead = x.shape[:-1]
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            y = int4_ops.int4_matmul(x2, w.data, w.scales, group=w.group)
            return y.reshape(*lead, w.n)
        return x @ dequantize(w, torch.bfloat16).to(x.dtype)
    return x @ w


def weight_bytes_streamed(w) -> float:
    """Per-use analytic HBM weight traffic (bytes) for the floor model."""
    if isinstance(w, QuantizedTensor):
        return w.nbytes_streamed
    return w.numel() * w.element_size()
