"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + shared
attention blocks.

38 Mamba2 layers, d_model=2048, ssm_state=64; one shared-weight
attention+MLP block (32H kv=32, head_dim 64, d_ff 8192) applied every 6
layers.  Simplifications vs HF reference noted in DESIGN.md §5 (single
shared block, no per-application LoRA).  Sliding window 4096 caps the
shared-attention KV at the long_500k shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    tie_embeddings=True,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    sliding_window=4096,
    max_seq_len=1_048_576,
)
