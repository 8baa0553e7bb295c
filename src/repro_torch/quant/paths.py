"""The single matmul entry point all models route linear layers through.

Plain tensors take ``x @ w``; ``QuantizedTensor`` weights dispatch on
their ``path``:

  dequant — materialise the weight in x's dtype, then matmul (traffic
            >= W_bf16: the trap)
  fused   — 2-D int4 weights go through the int4 kernel
            (kernels/int4_matmul: the card launches it, a CPU tensor
            takes its plain version); other fused weights multiply a
            bf16 dequantisation, as the reference does off its TPU, and
            are charged its bytes (``QuantizedTensor.int4_kernel``).

``expert_einsum`` is the same entry point for the MoE's stacked (E, K, N)
expert weights.
"""
from __future__ import annotations

import torch

from repro_torch.quant.quantize import QuantizedTensor, dequantize


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w (K, N) with quant-path dispatch."""
    if isinstance(w, QuantizedTensor):
        if w.path == "dequant":
            return x @ dequantize(w, x.dtype)
        if w.int4_kernel:
            from repro_torch.kernels.int4_matmul import ops as int4_ops
            lead = x.shape[:-1]
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            y = int4_ops.int4_matmul(x2, w.data, w.scales, group=w.group)
            return y.reshape(*lead, w.n)
        return x @ dequantize(w, torch.bfloat16).to(x.dtype)
    return x @ w


def expert_einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """Batched expert matmul 'ecd,edf->ecf' / 'ecf,efd->ecd' with
    quant-path dispatch on stacked (E, K, N) weights.  Both quant paths
    multiply by a dequantisation of the whole stack in x's dtype, as the
    reference does; ``QuantizedTensor.nbytes_streamed`` charges that
    copy's write and read (``int4_kernel`` is False for 3-D weights)."""
    if isinstance(w, QuantizedTensor):
        return torch.einsum(spec, x, dequantize(w, x.dtype))
    return torch.einsum(spec, x, w)


def weight_bytes_streamed(w) -> float:
    """Per-use analytic HBM weight traffic (bytes) for the floor model."""
    if isinstance(w, QuantizedTensor):
        return w.nbytes_streamed
    return w.numel() * w.element_size()
