"""Plain PyTorch version of the RMSNorm kernel.

The same function as ``csrc/rmsnorm.cu`` and as the TPU kernel
``repro.kernels.rmsnorm`` computes: the mean of squares and the scaling
in f32, the result rounded once to x's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, w: Optional[torch.Tensor],
                eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), w (D,) or None (the non-parametric variant) -> x's
    shape and dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)
