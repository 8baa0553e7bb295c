"""Plain PyTorch version of the decode-attention kernel.

The same function as ``csrc/decode_attention.cu`` and as the TPU kernel
``repro.kernels.decode_attention`` computes: an f32 einsum and an
explicitly written masked softmax (masked scores -1e30, masked
probabilities 0, output ``acc / max(l, 1e-30)``), so a row with no
valid slot gives zeros rather than NaN.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd); k/v (B, S, Hkv, hd); mask (S,) or (B, S), nonzero =
    valid.  Returns (B, Hq, hd) in q's dtype."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    valid = (mask != 0).reshape(-1, S).expand(B, S)[:, None, None, :]
    qg = q.reshape(B, Hkv, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (hd ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, hd).to(q.dtype)
