"""Shared model primitives: norms, RoPE / M-RoPE, MLPs, the loss, init
helpers.

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
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.launch import hints

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
    """RMSNorm in f32; w=None gives the non-parametric variant (OLMo).
    A CUDA tensor runs the RMSNorm kernel (kernels/rmsnorm), a CPU
    tensor its plain version."""
    return rmsnorm_ops.rmsnorm(x, w, eps)


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
    h = hints.constrain(h, ("dp",) + (None,) * (h.dim() - 2) + ("tp",))
    return matmul(h, p["down"])


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------

def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  A DTensor table split over the
    vocab (``launch/sharding.py``'s embed rule) is looked up on each
    rank's rows, the other ranks' tokens giving zeros, and the parts are
    summed (an all-reduce over the vocab's mesh dims); the result keeps
    the tokens' batch split, replicated elsewhere."""
    if not _dt.is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    n_mesh = mesh.ndim
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    table = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                      for v in vocab])
    if not _dt.is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * n_mesh,
                                    run_check=False)
    rows = [isinstance(p, Shard) and p.dim == 0 and not vocab[m]
            for m, p in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, [Shard(0) if r else Replicate()
                                        for r in rows])
    off, n = _dt.shard_span(table, 0)
    grad = [Shard(0) if vocab[m] else Partial() if rows[m] else Replicate()
            for m in range(n_mesh)]
    tl = table.to_local(grad_placements=grad)
    idx = tokens.to_local() - off
    inside = (idx >= 0) & (idx < n)
    x = F.embedding(idx.clamp(0, n - 1), tl) * inside[..., None].to(tl.dtype)
    x = DTensor.from_local(x, mesh, [Partial() if vocab[m] else
                                     Shard(0) if rows[m] else Replicate()
                                     for m in range(n_mesh)], run_check=False)
    return x.redistribute(mesh, [Shard(0) if rows[m] else Replicate()
                                 for m in range(n_mesh)])


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE; logits (..., V) upcast to f32; labels (...)
    (the audio family's (B, S, K, V) logits with (B, S, K) labels too).
    ``z_loss`` adds z_loss * mean(logsumexp^2).

    DTensor logits: each rank takes the mean over its own rows (the
    vocab gathered where it is split) scaled by its share of the rows,
    and the ranks' parts are summed (an all-reduce): the mean over all
    rows, replicated."""
    if _dt.is_dtensor(logits):
        from torch.distributed.tensor import Replicate
        n = labels.numel()
        rows = "abcdefgh"[:labels.dim()]
        loss = _dt.local_call(
            lambda lg, lb: cross_entropy(lg, lb, z_loss) * (lb.numel() / n),
            [(logits, rows + "."), (labels, rows)], [""], sums=(True,))
        return loss.redistribute(loss.device_mesh,
                                 [Replicate()] * loss.device_mesh.ndim)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.long()[..., None], dim=-1)[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss
