"""Weight quantisation: int8 and packed-int4 with per-group scales.

Port of ``repro.quant.quantize``, with the same layout and the same
codes bit for bit: weights are (..., K, N); scales are f32
(..., K//group, N), one per group of ``group`` rows along K; int4 packs
two adjacent-K nibbles per uint8 along axis -2 (low nibble = even k).
Rounding is half to even in both frameworks.

The ``path`` attached to a quantised tensor selects how ``quant.paths``
multiplies by it:

  dequant — materialise the bf16 weight, then matmul (traffic >= W_bf16)
  fused   — the int4 kernel reads the packed codes and scales and never
            writes a bf16 weight (traffic ~= W/4 + scales)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

DEFAULT_GROUP = 128


@dataclasses.dataclass
class QuantizedTensor:
    """A quantised weight living in a params tree.

    data:   int8 (..., K, N) for w8, or uint8 (..., K//2, N) for w4
    scales: f32 (..., K//group, N)
    """
    data: torch.Tensor
    scales: torch.Tensor
    bits: int
    path: str  # "dequant" | "fused"

    @property
    def k(self) -> int:
        return self.data.shape[-2] * (2 if self.bits == 4 else 1)

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def group(self) -> int:
        return self.k // self.scales.shape[-2]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[:-2]) + (self.k, self.n)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes_streamed(self) -> float:
        """Analytic HBM bytes streamed per use (floor-model numerator)."""
        d = self.data.numel() * self.data.element_size()
        s = self.scales.numel() * self.scales.element_size()
        if self.path == "dequant":
            # write + read back the materialised bf16 copy
            return d + s + 2 * math.prod(self.shape) * 2
        return d + s


def quantize(w: torch.Tensor, bits: int, group: int = DEFAULT_GROUP,
             path: str = "fused") -> QuantizedTensor:
    """w (..., K, N) -> QuantizedTensor, per-group scales along K.  Runs on
    w's device."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    K, N = w.shape[-2], w.shape[-1]
    group = min(group, K)
    if K % group:
        raise ValueError(f"K={K} is not a multiple of group {group}")
    qmax = 7 if bits == 4 else 127
    g = w.float().reshape(*w.shape[:-2], K // group, group, N)
    scales = g.abs().amax(dim=-2) / qmax + 1e-12              # (..., K//group, N)
    q = torch.clamp(torch.round(g / scales[..., None, :]), -qmax - 1, qmax)
    q = q.to(torch.int8).reshape(w.shape)
    if bits == 8:
        return QuantizedTensor(q, scales, 8, path)
    if K % 2:
        raise ValueError("int4 packing needs even K")
    lo = (q[..., 0::2, :] & 0xF).to(torch.uint8)
    hi = (q[..., 1::2, :] & 0xF).to(torch.uint8)
    return QuantizedTensor((lo | (hi << 4)).contiguous(), scales, 4, path)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K//2, N) -> int8 (..., K, N) in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-2)           # (..., K//2, 2, N)
    return out.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """codes * repeat(scales) in the target dtype (materialises the
    weight: this is the dequant path's traffic)."""
    q = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    s = torch.repeat_interleave(qt.scales.to(dtype), qt.group, dim=-2)
    return q.to(dtype) * s
