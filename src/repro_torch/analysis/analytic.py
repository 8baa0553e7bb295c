"""Closed-form FLOP / HBM-byte model per (arch x shape) cell.

Why this exists: XLA's ``cost_analysis()`` counts a while-loop body ONCE
(scan-over-layers => ~L-fold undercount), so the roofline needs an
independent, exact napkin model.  The dry-run records BOTH (and we
cross-validate on unrolled compiles, see EXPERIMENTS.md §Dry-run).

Conventions: FLOPs are global per step (divide by chips outside);
MODEL_FLOPS follows the assignment: 6*N*D tokens for train (dense) with
N = active params; HBM bytes are per-device given sharding degrees.

A copy of ``repro.analysis.analytic`` (pure arithmetic) on the port's
``configs`` and ``core/floor.py`` copies, held equal to the original by
``tests/test_torch_analysis.py``.  The port's dry run
(``launch/dryrun.py``) records FLOPs from ``FlopCounterMode`` beside it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import floor as fl


@dataclasses.dataclass
class CellEstimate:
    flops: float               # global per step (fwd+bwd for train)
    hbm_bytes_per_chip: float  # per device per step
    model_flops: float         # assignment's 6*N*D (or 6*N_active*D)
    detail: Dict


def _attn_flops_full(cfg: ArchConfig, B: int, S: int) -> float:
    """Causal QK^T + PV: 2 * 2 * B * S^2/2 * Hq * hd (per layer)."""
    if cfg.n_heads == 0:
        return 0.0
    per_layer = 2 * 2 * B * (S * S / 2) * cfg.n_heads * cfg.head_dim
    return per_layer * cfg.n_attn_layers


def _ssd_flops_full(cfg: ArchConfig, B: int, S: int, chunk: int = 128) -> float:
    """Chunked SSD per layer: intra-chunk (S*chunk quadratic) + state ops."""
    if cfg.n_ssm_layers == 0:
        return 0.0
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(chunk, S)
    intra = 2 * B * S * q * H * (N + P)          # CB^T L + (.)x
    states = 2 * B * S * H * P * N * 2           # build + apply chunk states
    return (intra + states) * cfg.n_ssm_layers


def forward_flops(cfg: ArchConfig, B: int, S: int) -> float:
    """Full-sequence forward FLOPs (matmul-dominated terms)."""
    n_act = fl.active_param_count(cfg)
    # every weight param does 2 flops per token (matmul)
    mat = 2.0 * n_act * B * S
    return mat + _attn_flops_full(cfg, B, S) + _ssd_flops_full(cfg, B, S)


def decode_flops(cfg: ArchConfig, B: int, ctx: int) -> float:
    n_act = fl.active_param_count(cfg)
    mat = 2.0 * n_act * B
    if cfg.n_heads:
        eff = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        mat += 2 * 2 * B * eff * cfg.n_heads * cfg.head_dim * cfg.n_attn_layers
    if cfg.n_ssm_layers:
        H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        mat += 2 * B * H * P * N * 2 * cfg.n_ssm_layers
    return mat


def estimate(cfg: ArchConfig, shape: ShapeSpec, *, n_chips: int,
             tp: int, dp: int, weight_dtype_bytes: float = 2,
             kv_dtype_bytes: float = 2, remat: str = "blocks") -> CellEstimate:
    B, S = shape.global_batch, shape.seq_len
    W = fl.weight_bytes(cfg, weight_dtype_bytes)
    n_params = fl.param_count(cfg)
    n_active = fl.active_param_count(cfg)
    d = {}

    if shape.kind == "train":
        fwd = forward_flops(cfg, B, S)
        # bwd ~ 2x fwd; remat="blocks" adds ~1 extra fwd of the blocks
        remat_extra = {"none": 0.0, "blocks": 1.0, "full": 1.0}[remat]
        flops = fwd * (3.0 + remat_extra)
        model_flops = 6.0 * n_active * B * S
        # per-chip HBM: params read(fwd+bwd) + grad write + adam moments r/w
        w_chip = W / n_chips          # fsdp/zero shards across all chips
        opt = 8.0 * n_params / n_chips * 2      # f32 mu+nu read+write
        act = 2.0 * cfg.n_layers * B * S * cfg.d_model * 2 / dp * 2
        hbm = 3 * w_chip + opt + act
        d.update(fwd_flops=fwd, opt_bytes=opt, act_bytes=act)
    elif shape.kind == "prefill":
        flops = forward_flops(cfg, B, S)
        model_flops = 2.0 * n_active * B * S
        w_chip = W / tp
        act = 2.0 * cfg.n_layers * B * S * cfg.d_model * 2 / dp
        kv_write = fl.kv_bytes(cfg, S, kv_dtype_bytes) * B / n_chips
        hbm = w_chip + act + kv_write
        d.update(kv_write=kv_write)
    else:  # decode
        flops = decode_flops(cfg, B, S)
        model_flops = 2.0 * n_active * B
        w_chip = fl.weight_bytes(cfg, weight_dtype_bytes, active=B == 1) / tp
        kv = fl.kv_bytes(cfg, S, kv_dtype_bytes) * B / n_chips
        hbm = w_chip + kv
        d.update(kv_bytes=kv, w_chip=w_chip)

    return CellEstimate(flops, hbm, model_flops, d)
