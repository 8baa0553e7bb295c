"""Token sampling on the device: greedy / temperature / top-k, batched."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, gen: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (..., V) -> int32 token ids (...), computed where the logits
    are.  Temperature sampling draws from ``gen``, which must live on the
    logits' device."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits.float() / temperature
    if top_k:
        kth = torch.sort(lf, dim=-1).values[..., -top_k][..., None]
        lf = torch.where(lf < kth, float("-inf"), lf)
    probs = torch.softmax(lf, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=gen)
    return ids.reshape(probs.shape[:-1]).to(torch.int32)
