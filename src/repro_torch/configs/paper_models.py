"""The paper's own three 7-8B GQA models (paper §3.3).

These exist to validate the floor model against the paper's Table 9 and
to run the paper-faithful benchmark suite; they are full members of the
registry (``--arch qwen2.5-7b`` etc.).

Paper-quoted weight footprints (decimal GB, bf16):
  Qwen-2.5-7B  W=15.23   Mistral-7B-v0.3  W=14.50   Llama-3.1-8B  W=16.06
and per-token KV bytes for Qwen-2.5-7B: 2*28*4*128*2 = 56 KB.
Unit tests assert our exact param arithmetic reproduces these.
"""
from repro_torch.configs.base import ArchConfig

QWEN25_7B = ArchConfig(
    name="qwen2.5-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

MISTRAL_7B = ArchConfig(
    name="mistral-7b-v0.3",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32768,
    rope_theta=1e6,
)

LLAMA31_8B = ArchConfig(
    name="llama-3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
)
