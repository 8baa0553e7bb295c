"""Weights made from the seed, and the port's model built from the
configuration file.

The benchmark makes the weights itself, on the device and in the type
they are served in, one large call per kind of leaf (every layer's
``wq`` at once, and so on).  The same tensors go to the port (as its
parameter tree, whose leaves are views of them) and to the plain
reference; the reference reads nothing the port made.

Scales: embeddings N(0, 1); each matrix N(0, 1/fan_in), so every
projection keeps its input's scale; the LM head N(0, 1/d), so the logits
are about N(0, 1); q/k/v biases N(0, 0.1^2); norm weights 1 + N(0, 0.1^2).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

# the configuration file's keys the port's ArchConfig takes, by field
_ARCH_FIELDS = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
                "n_heads": "num_attention_heads",
                "n_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
                "d_ff": "intermediate_size", "vocab_size": "vocab_size",
                "qkv_bias": "attention_bias", "rope_theta": "rope_theta",
                "tie_embeddings": "tie_word_embeddings"}


def leaf_shapes(cfg: Mapping) -> Dict[str, tuple]:
    """Every weight, stacked over the layers where it is per layer."""
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    Q = cfg["num_attention_heads"] * cfg["head_dim"]
    K = cfg["num_key_value_heads"] * cfg["head_dim"]
    V = cfg["vocab_size"]
    shapes = {"embed": (V, D), "wq": (L, D, Q), "wk": (L, D, K),
              "wv": (L, D, K), "wo": (L, Q, D), "gate": (L, D, F),
              "up": (L, D, F), "down": (L, F, D), "norm1": (L, D),
              "norm2": (L, D), "final_norm": (D,)}
    if cfg["attention_bias"]:
        shapes.update(bq=(L, Q), bk=(L, K), bv=(L, K))
    if not cfg["tie_word_embeddings"]:
        shapes["lm_head"] = (V, D)
    return shapes


def _scale(name: str, shape: tuple) -> float:
    if name == "embed":
        return 1.0
    if name in ("bq", "bk", "bv", "norm1", "norm2", "final_norm"):
        return 0.1
    return shape[-1 if name == "lm_head" else -2] ** -0.5


def make_weights(cfg: Mapping, seed: int, device,
                 out: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Draw every weight from ``seed`` on ``device``; with ``out``, draw
    into those tensors in place (the same addresses, so captured graphs
    stay valid)."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    dtype = DTYPES[cfg["torch_dtype"]]
    weights = out if out is not None else {}
    for name, shape in leaf_shapes(cfg).items():
        t = weights.get(name)
        if t is None:
            t = weights[name] = torch.empty(shape, dtype=dtype, device=device)
        mean = 1.0 if name.startswith("norm") or name == "final_norm" else 0.0
        t.normal_(mean, _scale(name, shape), generator=gen)
    return weights


def port_params(cfg: Mapping, w: Mapping[str, torch.Tensor]) -> dict:
    """The port's parameter tree over the same tensors (views, no copy)."""
    def block(i):
        attn = {k: w[k][i] for k in ("wq", "wk", "wv", "wo")}
        if cfg["attention_bias"]:
            attn.update({k: w[k][i] for k in ("bq", "bk", "bv")})
        return {"norm1": w["norm1"][i], "attn": attn, "norm2": w["norm2"][i],
                "mlp": {k: w[k][i] for k in ("gate", "up", "down")}}
    params = {"embed": w["embed"],
              "blocks": [block(i) for i in range(cfg["num_hidden_layers"])],
              "final_norm": w["final_norm"]}
    if not cfg["tie_word_embeddings"]:
        params["lm_head"] = w["lm_head"]
    return params


def port_model(cfg: Mapping, device):
    """The port's ``Model`` for this configuration: its registry entry with
    every size the file states put over it, so the file is what runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    arch = get_config(cfg["arch"]).replace(
        dtype=cfg["torch_dtype"],
        **{field: cfg[key] for field, key in _ARCH_FIELDS.items()})
    if arch.family != "dense" or not arch.mlp_gated or arch.norm != "rmsnorm" \
            or arch.sliding_window:
        raise ValueError(f"{cfg['arch']}: the benchmark's reference computes "
                         "dense gated-MLP RMSNorm decoders with full attention")
    return Model(arch, device=device)
