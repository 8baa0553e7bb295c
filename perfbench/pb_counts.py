"""The yardstick: operations and bytes the benchmark charges for a piece of
work, and the peaks it divides by.

Counts follow the configuration file (its Hugging Face keys), never the
program, so a change to the program cannot move them.  Bytes count each
input read once and each output written once; where the work depends on
the data (a cache read up to a lane's live length) they count what the
inputs need, not the most the kernel could read.

Peaks: one NVIDIA H100 SXM at its full 700 W power limit (NVIDIA's data
sheet, dense rates): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Tuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes of a dense GQA decoder that the counts need."""
    layers: int
    d: int
    ff: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    qkv_bias: bool
    tied: bool
    elem_bytes: int = 2

    @classmethod
    def of(cls, cfg: Mapping) -> "Shape":
        return cls(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                   ff=cfg["intermediate_size"],
                   heads=cfg["num_attention_heads"],
                   kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg["head_dim"], vocab=cfg["vocab_size"],
                   qkv_bias=bool(cfg["attention_bias"]),
                   tied=bool(cfg["tie_word_embeddings"]),
                   elem_bytes={"bfloat16": 2, "float16": 2,
                               "float32": 4}[cfg["torch_dtype"]])

    @property
    def q_width(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def linear_params(self) -> int:
        """Matrix elements of one layer: q, k, v, o and the gated MLP."""
        attn = 2 * self.d * self.q_width + 2 * self.d * self.kv_width
        return attn + 3 * self.d * self.ff

    @property
    def layer_params(self) -> int:
        """Every parameter of one layer: matrices, q/k/v biases, two norms."""
        bias = self.q_width + 2 * self.kv_width if self.qkv_bias else 0
        return self.linear_params + bias + 2 * self.d

    @property
    def head_params(self) -> int:
        return self.vocab * self.d

    @property
    def weight_bytes(self) -> int:
        """What one decode step reads of the weights: every layer, the
        final norm and the LM head once, and one embedding row a lane
        (charged in ``decode_step``)."""
        params = self.layers * self.layer_params + self.d + self.head_params
        return params * self.elem_bytes

    @property
    def kv_bytes_per_token(self) -> int:
        return 2 * self.layers * self.kv_width * self.elem_bytes

    def attn_flops(self, queries: int, keys: int) -> int:
        """Scores and the weighted sum for ``queries`` x ``keys`` pairs in
        every layer."""
        return 4 * self.heads * self.head_dim * queries * keys * self.layers


def decode_step(shape: Shape, lens: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step over lanes whose live lengths
    (positions cached after this step's write) are ``lens``: the weights
    once, an embedding row, the KV read at the live positions and the one
    row written, for each lane."""
    lens = list(lens)
    flops = sum(2 * (shape.layers * shape.linear_params + shape.head_params)
                + shape.attn_flops(1, n) for n in lens)
    nbytes = (shape.weight_bytes
              + sum(shape.d * shape.elem_bytes
                    + (n + 1) * shape.kv_bytes_per_token for n in lens))
    return float(flops), float(nbytes)


def prefill(shape: Shape, start: int, length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of prefilling positions ``start .. start+length-1``
    of one sequence whose first ``start`` positions are cached: the
    projections at every position, causal attention over the prefix and
    the chunk, the LM head at the last position only; the weights and the
    embedding rows once, the prefix's KV read and the chunk's written."""
    causal_keys = length * start + length * (length + 1) // 2
    flops = (2 * shape.layers * shape.linear_params * length
             + shape.attn_flops(1, causal_keys)
             + 2 * shape.head_params)
    nbytes = (shape.weight_bytes + length * shape.d * shape.elem_bytes
              + (start + length) * shape.kv_bytes_per_token)
    return float(flops), float(nbytes)


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the chip needs at the least: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def decode_attention_bytes(shape: Shape, live: int) -> float:
    """Kernel 1, one layer and one lane: K and V at the live positions, q
    and the output."""
    return float(2 * live * shape.kv_width * shape.elem_bytes
                 + 2 * shape.q_width * shape.elem_bytes)


def paged_attention_bytes(shape: Shape, lens: Iterable[int],
                          page_size: int) -> float:
    """Kernel 2, one layer over a batch: the pages that hold each live
    lane's positions (K and V), and each live lane's q and output."""
    total = 0
    for n in lens:
        pages = -(-n // page_size)
        total += (2 * pages * page_size * shape.kv_width * shape.elem_bytes
                  + 2 * shape.q_width * shape.elem_bytes)
    return float(total)
