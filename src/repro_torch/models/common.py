"""Shared model primitives: norms, RoPE / M-RoPE, MLPs, init helpers.

Port of ``repro.models.common``.  Params are nested dicts of tensors;
every init function draws from an explicit ``torch.Generator`` on the
device it allocates on.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale^2) in f32 on ``gen``'s device, cast to ``dtype``;
    ``scale`` defaults to 1/sqrt(d_in)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32; w=None gives the non-parametric variant (OLMo)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def init_norm(cfg: ArchConfig, dtype, device, d: Optional[int] = None):
    if cfg.norm == "nonparametric":
        return None
    return torch.ones((d or cfg.d_model,), dtype=dtype, device=device)


def apply_norm(x, w):
    return rmsnorm(x, w)


# --------------------------------------------------------------------------
# RoPE (rotate-half convention) and Qwen2-VL M-RoPE
# --------------------------------------------------------------------------

def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rope_angles(positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim/2)."""
    return positions[..., None].float() * inv_freq


def mrope_angles(positions_thw: torch.Tensor, inv_freq: torch.Tensor,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions (..., S, 3) (t,h,w ids), sections sum to
    head_dim/2.  Each frequency band takes its angle from its section's
    position stream.  Text-only tokens carry t==h==w, reducing to RoPE."""
    angles = positions_thw[..., None, :].float() * inv_freq[:, None]  # (...,S,hd/2,3)
    sel = torch.cat([torch.full((s,), i, dtype=torch.long, device=angles.device)
                     for i, s in enumerate(sections)])                # (hd/2,)
    idx = sel[:, None].expand(angles.shape[:-1] + (1,))
    return torch.take_along_dim(angles, idx, dim=-1)[..., 0]


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); angles (B?, S, hd/2) broadcastable over heads."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def make_angle_fn(cfg: ArchConfig, device=None):
    """Return positions->angles for this arch (plain RoPE or M-RoPE)."""
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device)
    if cfg.mrope_sections is not None:
        sections = cfg.mrope_sections

        def angle_fn(positions):
            if positions.shape[-1] != 3:   # text-only stream: expand t==h==w
                positions = positions[..., None].expand(positions.shape + (3,))
            return mrope_angles(positions, inv_freq, sections)
        return angle_fn

    def angle_fn(positions):
        return _rope_angles(positions, inv_freq)
    return angle_fn


# --------------------------------------------------------------------------
# MLP (SwiGLU or plain GELU)
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype) -> Params:
    p = {"up": dense_init(gen, d_model, d_ff, dtype),
         "down": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp_forward(p: Params, x: torch.Tensor, gated: bool) -> torch.Tensor:
    from repro_torch.quant.paths import matmul
    if gated:
        h = F.silu(matmul(x, p["gate"])) * matmul(x, p["up"])
    else:
        h = F.gelu(matmul(x, p["up"]), approximate="tanh")   # jax.nn.gelu's default
    return matmul(h, p["down"])
