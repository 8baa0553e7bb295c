"""Architecture configuration dataclass + shape registry.

Every assigned architecture is an ``ArchConfig`` instance in its own
module under ``repro_torch.configs``; ``repro_torch.configs.get_config(name)``
resolves them.  ``reduced()`` returns a CPU-smoke-test-sized config of
the same family (same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1, "int4": 0.5}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    # backbone
    n_layers: int
    d_model: int
    n_heads: int = 0          # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0             # dense-FFN intermediate (0 for mamba2-pure)
    vocab_size: int = 32000

    # flavour flags
    qkv_bias: bool = False
    mlp_gated: bool = True           # SwiGLU (3 mats) vs plain (2 mats)
    norm: str = "rmsnorm"            # rmsnorm | nonparametric
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # attention window cap (hybrid long-ctx)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per routed expert
    n_shared_experts: int = 0
    shared_d_ff: int = 0             # total shared-expert intermediate
    capacity_factor: float = 1.25
    router_type: str = "softmax_topk"  # softmax_topk | sigmoid_top1

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1              # number of B/C groups (like GQA for SSM)

    # hybrid (zamba2-style)
    attn_every: int = 0              # apply the shared attention block every N layers

    # modality frontends (stubs)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    n_codebooks: int = 0             # musicgen EnCodec codebooks

    # numerics / limits
    dtype: str = "bfloat16"
    max_seq_len: int = 32768

    # ---------------- derived ----------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def conv_channels(self) -> int:
        # mamba2 conv runs over x + B + C streams
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid (windowed attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            # shared attention applied at layers 0, attn_every, 2*attn_every, ...
            return (self.n_layers + self.attn_every - 1) // self.attn_every
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.n_layers
        return 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (one forward/train step)."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            vocab_size=256,
            max_seq_len=128,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2, head_dim=32)
            if self.mrope_sections:
                kw.update(mrope_sections=(4, 6, 6))   # sums to head_dim/2 = 16
        if self.d_ff:
            kw.update(d_ff=256)
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, 8), top_k=min(self.top_k, 2),
                      moe_d_ff=64,
                      shared_d_ff=64 if self.shared_d_ff else 0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.sliding_window:
            kw.update(sliding_window=64)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic attention (see DESIGN.md §5)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
