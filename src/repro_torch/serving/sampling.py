"""Token sampling on the device: greedy / temperature / top-k, batched.

A temperature draw is the reference's ``jax.random.categorical``: the
argmax of the scaled, top-k-masked logits plus Gumbel noise.  The noise
is ``-log(E)`` with ``E ~ Exp(1)`` drawn from ``gen`` on the logits'
device, so a draw needs no softmax and reads nothing back to the host,
and a captured CUDA graph can hold it (with ``gen`` registered to the
graph, ``core/dispatch.capture``)."""
from __future__ import annotations

from typing import Optional

import torch

# E is clamped to the smallest positive normal f32: at E = 0 the noise
# -log(E) is +inf, and a masked logit's -inf + inf is NaN, which
# ``torch.argmax`` takes as the maximum.  The CPU's ``exponential_`` can
# return 0; the card's smallest is 2^-24 (``scripts/sampling_probe.py``).
_TINY = torch.finfo(torch.float32).tiny


def gumbel_argmax(lf: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """argmax(lf - log(max(e, tiny))) over the last axis, int32: the
    categorical draw from the logits ``lf`` given the Exp(1) variates
    ``e`` (same shape)."""
    return torch.argmax(lf - torch.log(e.clamp_min(_TINY)), dim=-1).to(torch.int32)


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
    return gumbel_argmax(lf, torch.empty_like(lf).exponential_(generator=gen))
