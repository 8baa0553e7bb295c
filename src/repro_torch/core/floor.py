"""The paper's analytic memory-floor model, exact per architecture.

t_floor(G, M, ctx) = (W(M) + K(M, ctx)) / B_peak(G)          (paper §3.4)
R_floor           = t_floor / t_obs

W is exact parameter-count × dtype-bytes arithmetic per family (dense /
moe / ssm / hybrid / vlm / audio).  K is the per-decode-step KV bytes
touched: 2 · n_attn_layers · n_kv_heads · head_dim · ctx · dtype_bytes
(paper §3.4); for SSM archs K degenerates to a constant-size state term.

Everything here is closed-form and unit-tested against the paper's own
Table 9 numbers (Qwen-2.5-7B / Mistral-7B / Llama-3.1-8B × 4 GPUs).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import ChipSpec


# --------------------------------------------------------------------------
# Parameter counting (exact)
# --------------------------------------------------------------------------

def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.head_dim
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _dense_mlp_params(d_model: int, d_ff: int, gated: bool) -> int:
    return (3 if gated else 2) * d_model * d_ff


def _norm_params(cfg: ArchConfig) -> int:
    return 0 if cfg.norm == "nonparametric" else cfg.d_model


def _moe_layer_params(cfg: ArchConfig) -> int:
    router = cfg.d_model * cfg.n_experts
    routed = cfg.n_experts * _dense_mlp_params(cfg.d_model, cfg.moe_d_ff, cfg.mlp_gated)
    shared = (_dense_mlp_params(cfg.d_model, cfg.shared_d_ff, cfg.mlp_gated)
              if cfg.shared_d_ff else 0)
    return router + routed + shared


def _moe_layer_active_params(cfg: ArchConfig) -> int:
    router = cfg.d_model * cfg.n_experts
    routed = cfg.top_k * _dense_mlp_params(cfg.d_model, cfg.moe_d_ff, cfg.mlp_gated)
    shared = (_dense_mlp_params(cfg.d_model, cfg.shared_d_ff, cfg.mlp_gated)
              if cfg.shared_d_ff else 0)
    return router + routed + shared


def _mamba_layer_params(cfg: ArchConfig) -> int:
    d_in = cfg.d_inner
    h = cfg.n_ssm_heads
    in_proj = cfg.d_model * (2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + h)
    conv = cfg.conv_channels * cfg.ssm_conv + cfg.conv_channels  # depthwise + bias
    scalars = 3 * h                      # A_log, D, dt_bias
    gated_norm = d_in
    out_proj = d_in * cfg.d_model
    in_norm = _norm_params(cfg)
    return in_proj + conv + scalars + gated_norm + out_proj + in_norm


def _embedding_params(cfg: ArchConfig) -> int:
    tables = max(1, cfg.n_codebooks)     # musicgen: one table per codebook
    embed = tables * cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else tables * cfg.vocab_size * cfg.d_model
    return embed + head


def _attn_block_params(cfg: ArchConfig) -> int:
    """One full attention block: norms + attention + dense MLP."""
    p = _attn_params(cfg) + 2 * _norm_params(cfg)
    if cfg.d_ff:
        p += _dense_mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp_gated)
    return p


def param_count(cfg: ArchConfig) -> int:
    """Exact total parameter count."""
    p = _embedding_params(cfg) + _norm_params(cfg)     # + final norm
    if cfg.family in ("dense", "vlm", "audio"):
        p += cfg.n_layers * _attn_block_params(cfg)
    elif cfg.family == "moe":
        per_layer = (_attn_params(cfg) + 2 * _norm_params(cfg)
                     + _moe_layer_params(cfg))
        p += cfg.n_layers * per_layer
    elif cfg.family == "ssm":
        p += cfg.n_layers * _mamba_layer_params(cfg)
    elif cfg.family == "hybrid":
        p += cfg.n_layers * _mamba_layer_params(cfg)
        p += _attn_block_params(cfg)                   # ONE shared attn block
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return p


def active_param_count(cfg: ArchConfig) -> int:
    """Per-token streamed parameters (MoE: shared + top-k experts only)."""
    if cfg.family != "moe":
        return param_count(cfg)
    per_layer = (_attn_params(cfg) + 2 * _norm_params(cfg)
                 + _moe_layer_active_params(cfg))
    return _embedding_params(cfg) + _norm_params(cfg) + cfg.n_layers * per_layer


# --------------------------------------------------------------------------
# Byte accounting (the paper's W and K terms)
# --------------------------------------------------------------------------

def weight_bytes(cfg: ArchConfig, dtype_bytes: float = 2, active: bool = False) -> float:
    n = active_param_count(cfg) if active else param_count(cfg)
    return n * dtype_bytes


def kv_bytes_per_token(cfg: ArchConfig, dtype_bytes: float = 2) -> float:
    """Per-token KV-cache bytes: 2 * L_attn * H_kv * d_head * bytes (paper §3.4)."""
    return 2.0 * cfg.n_attn_layers * cfg.n_kv_heads * cfg.head_dim * dtype_bytes


def ssm_state_bytes(cfg: ArchConfig, dtype_bytes: float = 2) -> float:
    """Constant recurrent-state bytes (ctx-independent)."""
    if cfg.n_ssm_layers == 0:
        return 0.0
    per_layer = (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state   # SSD state h
                 + cfg.conv_channels * (cfg.ssm_conv - 1))            # conv window
    return cfg.n_ssm_layers * per_layer * dtype_bytes


def kv_bytes(cfg: ArchConfig, ctx: int, dtype_bytes: float = 2) -> float:
    """The paper's K(M, ctx): per-step cache bytes swept at context ``ctx``.

    Attention archs: linear in ctx (window-capped when cfg.sliding_window).
    SSM/hybrid archs additionally sweep the constant recurrent state.
    """
    eff_ctx = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
    return kv_bytes_per_token(cfg, dtype_bytes) * eff_ctx + ssm_state_bytes(cfg, dtype_bytes)


@dataclasses.dataclass(frozen=True)
class FloorCell:
    """One (arch, chip, ctx) cell of the paper's floor table."""
    arch: str
    chip: str
    ctx: int
    batch: int
    weight_bytes: float
    kv_bytes: float
    t_floor_s: float

    @property
    def t_floor_ms(self) -> float:
        return self.t_floor_s * 1e3

    def r_floor(self, t_obs_s: float) -> float:
        return self.t_floor_s / t_obs_s


def floor_cell(cfg: ArchConfig, chip: ChipSpec, ctx: int, *,
               batch: int = 1,
               weight_dtype_bytes: float = 2,
               kv_dtype_bytes: float = 2,
               active_weights: bool = True,
               n_chips: int = 1) -> FloorCell:
    """Analytic decode-step floor.

    batch-1: streamed weights = active set (MoE benefit).  batch>1: routed
    experts are touched ~min(E, batch*top_k)/E of fully, interpolated.
    ``n_chips`` divides the streamed bytes (weights and KV are sharded).
    """
    w_act = weight_bytes(cfg, weight_dtype_bytes, active=True)
    w_tot = weight_bytes(cfg, weight_dtype_bytes, active=False)
    if not active_weights or cfg.family != "moe":
        w = w_tot if not active_weights else w_act if batch == 1 else w_tot
    else:
        coverage = min(1.0, batch * max(cfg.top_k, 1) / max(cfg.n_experts, 1))
        w = w_act + coverage * (w_tot - w_act)
    k = kv_bytes(cfg, ctx, kv_dtype_bytes) * batch
    streamed = (w + k) / n_chips
    return FloorCell(cfg.name, chip.name, ctx, batch, w, k,
                     streamed / chip.hbm_bw)


def r_floor(t_floor_s: float, t_obs_s: float) -> float:
    return t_floor_s / t_obs_s
