"""Weight quantisation: int8 and packed-int4 with per-group scales.

Port of ``repro.quant.quantize``, with the same layout and the same
codes bit for bit: weights are (..., K, N); scales are f32
(..., K//group, N), one per group of ``group`` rows along K; int4 packs
two adjacent-K nibbles per uint8 along axis -2 (low nibble = even k).
Rounding is half to even in both frameworks.

The ``path`` attached to a quantised tensor selects how ``quant.paths``
multiplies by it:

  dequant — materialise the bf16 weight, then matmul (traffic >= W_bf16)
  fused   — 2-D int4 weights: the int4 kernel reads the packed codes and
            scales and never writes a bf16 weight (traffic ~= W/4 +
            scales); other fused weights (int8, and the moe's 3-D int4
            stacks) are multiplied by a bf16 dequantisation, written once
            by the dequantisation kernel and read once by the GEMM, and
            are charged as dequant (the reference charges them as fused,
            counting on XLA to fuse the cast into the matmul)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.kernels.dequantize import ops as dequantize_ops
from repro_torch.kernels.dequantize.ref import unpack_int4  # noqa: F401

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
    def int4_kernel(self) -> bool:
        """Whether ``quant.paths.matmul`` multiplies by this weight through
        the int4 kernel, which reads codes and scales and writes no bf16
        copy.  Every other quantised weight is multiplied by a
        dequantised copy, on the ``fused`` path too (int8, or int4 that
        is not 2-D)."""
        return self.path == "fused" and self.bits == 4 and self.ndim == 2

    @property
    def nbytes_streamed(self) -> float:
        """Analytic HBM bytes streamed per use (floor-model numerator)."""
        d = self.data.numel() * self.data.element_size()
        s = self.scales.numel() * self.scales.element_size()
        if self.int4_kernel:
            return d + s
        # codes and scales read once by the dequantisation kernel, which
        # writes the bf16 copy once; the GEMM reads the copy once
        return d + s + 2 * math.prod(self.shape) * 2


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


def quantize_int8(w: torch.Tensor, group: int = DEFAULT_GROUP,
                  path: str = "fused") -> QuantizedTensor:
    return quantize(w, 8, group, path)


def quantize_int4(w: torch.Tensor, group: int = DEFAULT_GROUP,
                  path: str = "fused") -> QuantizedTensor:
    return quantize(w, 4, group, path)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """codes * repeat(scales) in the target dtype, materialised in one
    pass (the dequant path's traffic): ``kernels/dequantize`` launches
    its kernel for CUDA codes and takes its plain version for CPU ones."""
    return dequantize_ops.dequantize(qt.data, qt.scales, qt.bits, dtype)
