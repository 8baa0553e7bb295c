"""Plain PyTorch versions of the RMSNorm kernels.

``rmsnorm_ref`` is the same function as ``csrc/rmsnorm.cu``'s forward
and as the TPU kernel ``repro.kernels.rmsnorm`` computes: the mean of
squares and the scaling in f32, the result rounded once to x's dtype.
``rmsnorm_bwd_ref`` is its gradient, as the backward kernel computes it
(the reference has no backward kernel: JAX differentiates its jnp
RMSNorm).
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def rmsnorm_bwd_ref(x: torch.Tensor, w: Optional[torch.Tensor],
                    dy: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``rmsnorm_ref`` at x (..., D), w (D,) or None, for
    the output's gradient dy (x's shape), with the math in f32:

        r  = rsqrt(mean(x^2) + eps)          (per row)
        g  = dy * w   (dy when w is None)
        dx = r g - x r^3 mean(g x)           (rounded once to x's dtype)
        dw = sum over rows of dy x r         (summed in f32, then w's dtype)

    Returns (dx, dw), dw None when w is None."""
    D = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = dyf * w.float() if w is not None else dyf
    dx = r * g - xf * (r * r * r) * torch.mean(g * xf, dim=-1, keepdim=True)
    dw = None
    if w is not None:
        dw = (dyf * xf * r).reshape(-1, D).sum(dim=0).to(w.dtype)
    return dx.to(x.dtype), dw
