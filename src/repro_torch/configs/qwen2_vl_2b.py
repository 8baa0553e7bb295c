"""Qwen2-VL-2B [arXiv:2409.12191; hf] — transformer BACKBONE only.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, M-RoPE
(3 sections over t/h/w position ids), dynamic-resolution vision tower is
a STUB per the assignment: ``input_specs()`` supplies precomputed patch
embeddings at d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    mrope_sections=(16, 24, 24),   # head_dim/2 = 64 = 16+24+24
    rope_theta=1e6,
)
