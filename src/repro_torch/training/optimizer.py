"""AdamW with global-norm clipping and LR schedules.

Port of ``repro.training.optimizer`` (init / update, dependency-free).
Moments are f32 whatever the param dtype; the update keeps each param's
dtype.  Unlike the reference, which returns new arrays (and donates the
old ones to the compiled step), ``update`` writes the params and the
moments **in place** and returns the same tensors.  The step counter,
the learning rate, the clip scale and the bias corrections are 0-dim
device tensors, so an update reads nothing back to the host and can be
captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.training.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-dim int32 on the params' device
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          tree_map(zeros, params), tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One AdamW step of ``params`` by ``grads`` (a tree like the
        params), in place.  Returns (params, state, {"grad_norm", "lr"})
        with the same params and state tensors."""
        state.step.add_(1)
        gnorm = global_norm(grads)
        if self.clip_norm is not None:
            # in f32, as jnp promotes a bf16 gradient times the f32 scale
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g.float() * scale, grads)

        b1, b2 = self.b1, self.b2
        step = state.step.float()
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        lr = self._lr(state.step)

        def upd(p, g, m, v):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        tree_map(upd, params, grads, state.mu, state.nu)
        return params, state, {"grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """step (a 0-dim tensor) -> lr: linear warm-up to ``peak_lr`` over
    ``warmup`` steps, then a cosine down to ``floor * peak_lr`` at
    ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr
