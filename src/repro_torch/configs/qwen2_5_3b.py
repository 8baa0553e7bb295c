"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B; family source hf:Qwen/Qwen2.5-0.5B].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias,
tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
