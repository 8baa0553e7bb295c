"""Mamba2-2.7B — SSD state-space duality [arXiv:2405.21060; unverified].

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads, 1 B/C group,
conv width 4.  Tied embeddings (mamba convention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    max_seq_len=1_048_576,   # sub-quadratic: long_500k applies
)
