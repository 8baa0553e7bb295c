"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) routed-expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared intermediate 5632).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                 # every FFN is MoE
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    shared_d_ff=5632,       # 4 x 1408
    router_type="softmax_topk",
    rope_theta=1e6,
)
