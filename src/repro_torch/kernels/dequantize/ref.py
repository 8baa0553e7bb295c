"""Plain PyTorch version of the dequantisation kernel.

The same function as ``csrc/dequantize.cu`` and as the reference's jnp
``repro.quant.quantize.dequantize`` (no TPU kernel: XLA fuses it into
the GEMM that reads it): int4 codes unpacked (low nibble = even row, a
nibble >= 8 takes 16 off) or int8 codes, times ``repeat(scales)``, in
the target dtype.
"""
from __future__ import annotations

import torch


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K//2, N) -> int8 (..., K, N) in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-2)           # (..., K//2, 2, N)
    return out.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])


def dequantize_ref(codes: torch.Tensor, scales: torch.Tensor, bits: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """codes (..., K//2, N) uint8 (bits 4) or (..., K, N) int8 (bits 8),
    scales f32 (..., K//group, N) -> codes * repeat(scales) in ``dtype``,
    (..., K, N)."""
    q = unpack_int4(codes) if bits == 4 else codes
    group = q.shape[-2] // scales.shape[-2]
    s = torch.repeat_interleave(scales.to(dtype), group, dim=-2)
    return q.to(dtype) * s
