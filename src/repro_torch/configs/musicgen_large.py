"""MusicGen-large decoder [arXiv:2306.05284; hf] — decoder-only over
EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048 per codebook,
4 EnCodec codebooks (sum-of-embeddings in, 4 LM heads out, delay-pattern
interleaving handled by the data stub).  Plain (non-gated) FFN.
head_dim = 2048/32 = 64.  Text-conditioning cross-attention is stubbed
(frontend provides frame embeddings), per the assignment.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_gated=False,
    n_codebooks=4,
    rope_theta=1e4,
)
