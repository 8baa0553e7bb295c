"""Mamba2 (SSD, state-space duality) blocks.

Port of ``repro.models.mamba2``.  Prefill runs the chunked SSD
algorithm (intra-chunk quadratic form plus the inter-chunk linear
recurrence, a Python loop over chunks where the reference scans); decode
is the O(1) recurrent update, whose SSD core is the SSD-update kernel
(kernels/ssd_update).  All SSD math in f32, params and activations in
the model dtype.

Layout: d_inner = expand * d_model channels split into H = d_inner / P
heads of dim P; B/C projections have G groups of state dim N, each group
serving H / G heads through a (g, hg) factorisation (no repeat is
materialised).

Unlike the reference, which returns new arrays, ``mamba_decode_step``
writes the new state and conv window into the tensors it is given.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_update import ops as ssd_ops
from repro_torch.launch import hints
from repro_torch.models.common import dense_init, rmsnorm
from repro_torch.quant.paths import matmul

Params = Dict[str, torch.Tensor]

DEFAULT_CHUNK = 128


def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    """Random Mamba2 block params drawn from ``gen`` on its device.
    A_log, D and dt_bias are f32 whatever the model dtype."""
    D, DI, H, N, G = (cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
                      cfg.ssm_state, cfg.ssm_groups)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_ch = cfg.conv_channels
    d_in_proj = 2 * DI + 2 * G * N + H
    # dt init: softplus(dt_bias) ~ U[1e-3, 1e-1] in log space
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand((H,), generator=gen, **f32))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen, **f32)
    return {
        "in_proj": dense_init(gen, D, d_in_proj, dtype),
        "conv_w": (conv_w / math.sqrt(cfg.ssm_conv)).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(1.0 + 15.0 * torch.rand((H,), generator=gen, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": dt_bias,
        "gate_norm": torch.ones((DI,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, DI, D, dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    DI, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    z = zxbcdt[..., :DI]
    xBC = zxbcdt[..., DI:2 * DI + 2 * G * N]
    dt = zxbcdt[..., 2 * DI + 2 * G * N:]
    if dt.shape[-1] != H:
        raise ValueError(f"projection width {zxbcdt.shape[-1]} does not match "
                         f"the config")
    return z, xBC, dt


def _split_xbc(cfg: ArchConfig, xBC: torch.Tensor):
    """Views of xBC (..., C): x (..., H, P), B and C (..., G, N)."""
    DI, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    lead = xBC.shape[:-1]
    return (xBC[..., :DI].reshape(*lead, cfg.n_ssm_heads, cfg.ssm_head_dim),
            xBC[..., DI:DI + G * N].reshape(*lead, G, N),
            xBC[..., DI + G * N:].reshape(*lead, G, N))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q): sum_{r=s+1..t} x_r on and below the
    diagonal, -inf above."""
    q = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    d = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, float("-inf"))


def _causal_conv_full(xBC: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width K in xBC's dtype: xBC (B,S,C),
    w (K,C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x, dt, A, Bm, Cm, h0, chunk: int = DEFAULT_CHUNK):
    """Chunked SSD scan.

    x (b,l,h,p) f32; dt (b,l,h) f32 (post-softplus); A (h,) f32
    (negative); Bm/Cm (b,l,g,n) f32; h0 (b,h,p,n) f32 initial state.
    Returns (y (b,l,h,p), h_final (b,h,p,n)).

    The reference's four-operand contractions are written as two-operand
    steps, so that no intermediate is larger than the (b,g,hg,c,q,q)
    decay matrix."""
    b, l, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hg = H // G
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    c = l // q

    xc = (x * dt[..., None]).reshape(b, c, q, G, hg, P)
    Bc = Bm.reshape(b, c, q, G, N)
    Cc = Cm.reshape(b, c, q, G, N)
    dA = (dt * A).reshape(b, c, q, G, hg).permute(0, 3, 4, 1, 2)  # (b,g,hg,c,q)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. intra-chunk: (C B^T) . L, then times x
    L = torch.exp(_segsum(dA))                                    # (b,g,hg,c,q,s)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)
    M = CB[:, :, :, None] * L.permute(0, 3, 1, 2, 4, 5)          # (b,c,g,hg,q,s)
    del L, CB
    Y_diag = torch.einsum("bcghqs,bcsghp->bcqghp", M, xc)
    del M

    # 2. per-chunk input states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)            # (b,g,hg,c,q)
    xd = xc * decay_states.permute(0, 3, 4, 1, 2)[..., None]      # (b,c,q,g,hg,p)
    states = torch.einsum("bcqgn,bcqghp->bcghpn", Bc, xd)

    # 3. inter-chunk recurrence (the only sequential part)
    chunk_decay = torch.exp(dA_cs[..., -1])                       # (b,g,hg,c)
    h = h0.reshape(b, G, hg, P, N)
    h_in = []
    for ci in range(c):
        h_in.append(h)                    # the state ENTERING chunk ci
        h = h * chunk_decay[..., ci, None, None] + states[:, ci]
    h_in = torch.stack(h_in, dim=1)                               # (b,c,g,hg,p,n)

    # 4. state -> output
    state_decay_out = torch.exp(dA_cs).permute(0, 3, 4, 1, 2)     # (b,c,q,g,hg)
    Y_off = torch.einsum("bcqgn,bcghpn->bcqghp", Cc, h_in)
    Y_off = Y_off * state_decay_out[..., None]

    y = (Y_diag + Y_off).reshape(b, l, H, P)
    return y, h.reshape(b, H, P, N)


def mamba_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, h0=None,
                  chunk: int = DEFAULT_CHUNK
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward (prefill).

    x (B,S,D); h0 (B,H,P,N) f32 initial state, zeros by default.  Returns
    (y (B,S,D), h_final, conv_state) so prefill can seed decode."""
    B, S, _ = x.shape
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = hints.constrain(matmul(x, p["in_proj"]), ("dp", None, "tp"))
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv_full(xBC, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _split_xbc(cfg, xBC)

    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    y, h_fin = ssd_chunked(xs.float(), dtf, A, Bm.float(), Cm.float(), h0,
                           chunk)
    y = y + xs.float() * p["D"][:, None]
    y = y.reshape(B, S, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    out = matmul(y, p["out_proj"])
    # conv state for decode continuation: the last K-1 pre-conv inputs,
    # projected again from the last K-1 normed inputs as the reference does
    K = cfg.ssm_conv
    if S >= K - 1:
        _, conv_tail, _ = _split_proj(cfg, matmul(x[:, S - (K - 1):, :],
                                                  p["in_proj"]))
    else:
        conv_tail = torch.zeros((B, K - 1, cfg.conv_channels), dtype=x.dtype,
                                device=x.device)
    return out, h_fin, conv_tail.to(x.dtype)


def mamba_decode_step(p: Params, x: torch.Tensor, h: torch.Tensor,
                      conv_state: torch.Tensor, cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) recurrent step.

    x (B,1,D); h (B,H,P,N) f32; conv_state (B,K-1,conv_ch).  Writes h'
    into ``h`` (through the SSD-update kernel on the card) and the
    shifted conv window into ``conv_state``, in place; returns
    (y (B,1,D), h, conv_state)."""
    B = x.shape[0]
    zxbcdt = matmul(x[:, 0, :], p["in_proj"])
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)

    # a new tensor, so the shift below never copies a tensor onto itself
    window = torch.cat([conv_state, xBC_new[:, None, :].to(conv_state.dtype)],
                       dim=1)                                    # (B,K,C)
    conv_out = (window.float() * p["conv_w"].float()).sum(dim=1) \
        + p["conv_b"].float()
    xs, Bm, Cm = _split_xbc(cfg, F.silu(conv_out))   # (B,H,P), (B,G,N), (B,G,N)

    dtf = F.softplus(dt.float() + p["dt_bias"])                  # (B,H)
    A = -torch.exp(p["A_log"])
    _, y = ssd_ops.ssd_update(h, xs, dtf, A, Bm, Cm, out=h)
    y = y + xs * p["D"][:, None]
    y = y.reshape(B, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    out = matmul(y, p["out_proj"])[:, None, :]
    conv_state.copy_(window[:, 1:, :])
    return out, h, conv_state
