"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 16 routed experts
top-1 + 1 shared expert.  ~17B active / ~108B total parameters.

Simplifications (DESIGN.md §5): RoPE on all layers (no iRoPE/NoPE split),
full attention (no chunked local attention), early-fusion frontend out of
scope for the LM shapes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    shared_d_ff=8192,
    router_type="sigmoid_top1",
    rope_theta=5e5,
)
