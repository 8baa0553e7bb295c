"""Plain PyTorch version of the SSD decode-step kernel.

The same function as ``csrc/ssd_update.cu`` and as the TPU kernel
``repro.kernels.ssd_update`` with its wrapper's broadcasts: one
recurrent step of the Mamba2 state per (batch, head), in f32.
"""
from __future__ import annotations

import torch


def ssd_update_ref(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                   A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor):
    """h (B,H,P,N) f32; x (B,H,P); dt (B,H) post-softplus; A (H,)
    negative; Bm/Cm (B,G,N) with G | H (head h reads group h // (H/G)).

    Returns (h' (B,H,P,N) f32, y (B,H,P) f32):
      h' = exp(dt*A) * h + (x*dt) (outer) B ;  y = h' . C"""
    H, G = h.shape[1], Bm.shape[1]
    rep = H // G
    dtf = dt.float()
    xdt = x.float() * dtf[..., None]
    decay = torch.exp(dtf * A.float()[None, :])[..., None, None]
    Bv = Bm.float().repeat_interleave(rep, dim=1)
    Cv = Cm.float().repeat_interleave(rep, dim=1)
    h_new = decay * h.float() + xdt[..., None] * Bv[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h_new, Cv)
    return h_new, y
