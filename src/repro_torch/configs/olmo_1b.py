"""OLMo-1B [arXiv:2402.00838; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (no learned scale), tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    tie_embeddings=True,
    rope_theta=1e4,
)
