"""Model assembly, dense family.

Port of ``repro.models.model`` with the same API, params passed in:

    m = Model(cfg, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    logits, aux = m.forward(params, batch)
    cache = m.init_cache(batch_size, max_len)
    logits, cache = m.prefill(params, batch, cache)
    logits, cache = m.decode_step(params, cache, tokens)

Params are a dict with the reference's keys (``embed``, ``blocks``,
``final_norm``, ``lm_head``); ``blocks`` is a Python list of per-layer
dicts where the reference stacks layers on a leading L axis.  Caches are
preallocated and updated **in place**: ``prefill`` and ``decode_step``
write into the cache they are given and return that same dict, and the
position ``pos`` is a 0-dim device tensor advanced in place, so a decode
step reads nothing back to the host and can replay at fixed addresses.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, apply_rope, embed_init,
                                       init_mlp, init_norm, make_angle_fn,
                                       mlp_forward)

Params = Dict[str, Any]
Cache = Dict[str, Any]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is wanted and absent — never falls back."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


class Model:
    def __init__(self, cfg: ArchConfig, *, decode_backend: str = "cuda",
                 device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the {cfg.family!r} family arrives with the other-families "
                "slice; this slice serves the dense family")
        if decode_backend not in attn.DECODE_BACKENDS:
            raise ValueError(f"decode_backend must be one of "
                             f"{attn.DECODE_BACKENDS}, got {decode_backend!r}")
        self.cfg = cfg
        self.decode_backend = decode_backend
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products in full f32, as the reference computes them
            # (TF32 keeps about three decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.angle_fn = make_angle_fn(cfg, self.device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_block(self, gen: torch.Generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "norm1": init_norm(cfg, dt, dev),
            "attn": attn.init_attention(gen, cfg, dt),
            "norm2": init_norm(cfg, dt, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dt),
        }

    def init(self, gen: torch.Generator) -> Params:
        """Random params drawn from ``gen``, which must live on the model's
        device (weights are made where they are used)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        cfg, dt = self.cfg, self.dtype
        params: Params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "blocks": [self._init_block(gen) for _ in range(cfg.n_layers)],
            "final_norm": init_norm(cfg, dt, self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
        return params

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def embed_tokens(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, params["embed"])

    def lm_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        return x @ head.T

    # ------------------------------------------------------------------
    # forward (prefill backbone)
    # ------------------------------------------------------------------
    def _attn_block_full(self, bp: Params, x, angles):
        cfg = self.cfg
        a_out, (k, v) = attn.attention_full(bp["attn"], apply_norm(x, bp["norm1"]),
                                            angles, cfg, apply_rope)
        x = x + a_out
        h = apply_norm(x, bp["norm2"])
        return x + mlp_forward(bp["mlp"], h, cfg.mlp_gated), (k, v)

    def backbone(self, params: Params, batch: Dict, *, collect_cache: bool = False):
        """Full-sequence backbone over ``batch["tokens"]`` (B, S).  Returns
        (hidden, aux, layer_caches) with layer_caches a list of per-layer
        (k, v) when ``collect_cache``."""
        x = self.embed_tokens(params, batch["tokens"])
        B, S = x.shape[0], x.shape[1]
        angles = self.angle_fn(torch.arange(S, device=x.device)[None, :].expand(B, S))
        kvs = []
        for bp in params["blocks"]:
            x, kv = self._attn_block_full(bp, x, angles)
            if collect_cache:
                kvs.append(kv)
        return x, 0.0, (kvs if collect_cache else None)

    def forward(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, float]:
        x, aux, _ = self.backbone(params, batch)
        x = apply_norm(x, params["final_norm"])
        return self.lm_logits(params, x), aux

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int, slotted: bool = False,
                   paged: bool = False, kv_quant: Optional[str] = None) -> Cache:
        """Contiguous static-batch KV cache on the model's device, in the
        model's dtype: ``k``/``v`` (L, B, kv_len, Hkv, hd), zeros, and
        ``pos`` a 0-dim int32 tensor.  With a sliding window
        kv_len = min(max_len, window) and the cache is a ring."""
        cfg = self.cfg
        if slotted or paged:
            raise NotImplementedError(
                "slotted and paged caches arrive with the paged / "
                "continuous-batching slice")
        if kv_quant not in (None, "none"):
            raise NotImplementedError("int8 KV caches arrive with the int8-KV "
                                      "quantisation slice")
        kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        shape = (cfg.n_layers, batch_size, kv_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "pos": torch.zeros((), dtype=torch.int32, device=self.device)}

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def prefill(self, params: Params, batch: Dict, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
        """Populate the cache from a full prompt, in place; returns the
        last-position logits and the same cache."""
        x, _, kvs = self.backbone(params, batch, collect_cache=True)
        S = x.shape[1]

        def place(slab: torch.Tensor, dst: torch.Tensor) -> None:
            """Write the last min(S, kv_len) keys into the (possibly ring)
            cache so that the token at absolute pos p lands at slot
            p % kv_len (no roll for a full cache)."""
            kv_len = dst.shape[1]
            s_eff = min(S, kv_len)
            kept = slab[:, S - s_eff:]
            if s_eff == kv_len and S % kv_len:
                kept = torch.roll(kept, S % kv_len, dims=1)
            dst[:, :s_eff].copy_(kept)

        for i, (k, v) in enumerate(kvs):
            place(k, cache["k"][i])
            place(v, cache["v"][i])
        cache["pos"].fill_(S)
        x_last = apply_norm(x[:, -1:], params["final_norm"])
        return self.lm_logits(params, x_last), cache

    def prefill_into_slot(self, *args, **kwargs):
        raise NotImplementedError("prefill_into_slot arrives with the paged / "
                                  "continuous-batching slice")

    def prefill_chunk_into_slot(self, *args, **kwargs):
        raise NotImplementedError("prefill_chunk_into_slot arrives with the "
                                  "paged / continuous-batching slice")

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _attn_block_decode(self, bp, x, k_cache, v_cache, write_pos, mask,
                           angles, backend=None):
        cfg = self.cfg
        a_out, _, _ = attn.attention_decode(
            bp["attn"], apply_norm(x, bp["norm1"]), k_cache, v_cache,
            write_pos, mask, angles, cfg, apply_rope,
            backend=backend or self.decode_backend)
        x = x + a_out
        h = apply_norm(x, bp["norm2"])
        return x + mlp_forward(bp["mlp"], h, cfg.mlp_gated)

    # staticcheck: hotpath
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One new token per sequence.  tokens (B,1).

        Writes each layer's new K/V row into the cache and advances
        ``cache["pos"]`` by one, all in place; returns (logits (B,1,V),
        the same cache).  The mask and the write slot are computed on the
        device from ``pos``: the step reads nothing back to the host."""
        cfg = self.cfg
        if active is not None or cache["pos"].dim():
            raise NotImplementedError(
                "per-slot positions and active-lane masking arrive with the "
                "paged / continuous-batching slice")
        x = self.embed_tokens(params, tokens)
        B = x.shape[0]
        pos = cache["pos"]
        kv_len = cache["k"].shape[2]
        ring = bool(cfg.sliding_window) and kv_len <= cfg.sliding_window
        write_pos = pos % kv_len if ring else pos
        mask = attn.decode_mask(pos, kv_len, ring=ring)
        angles = self.angle_fn(pos.reshape(1, 1).expand(B, 1))
        for i, bp in enumerate(params["blocks"]):
            x = self._attn_block_decode(bp, x, cache["k"][i], cache["v"][i],
                                        write_pos, mask, angles)
        pos.add_(1)
        x = apply_norm(x, params["final_norm"])
        return self.lm_logits(params, x), cache

    # staticcheck: hotpath
    def decode_steps(self, params: Params, cache: Cache, tokens: torch.Tensor,
                     gen: Optional[torch.Generator] = None,
                     steps_left: Optional[torch.Tensor] = None, *,
                     horizon: int, temperature: float = 0.0, top_k: int = 0,
                     eos_id: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Cache]:
        """Advance every sequence ``horizon`` tokens with on-device sampling
        (greedy argmax, or categorical draws from ``gen``), returning the
        token matrix (B, horizon) without reading anything back to the
        host.  Greedy streams are token-identical to ``horizon`` single
        ``decode_step`` calls."""
        from repro_torch.serving.sampling import sample
        if steps_left is not None or eos_id is not None:
            raise NotImplementedError(
                "steps_left / eos_id lane masking arrives with the paged / "
                "continuous-batching slice")
        toks = []
        tok = tokens
        for _ in range(horizon):
            logits, cache = self.decode_step(params, cache, tok)
            nxt = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
            toks.append(nxt)
            tok = nxt[:, None]
        return torch.stack(toks, dim=1), cache

    def step_program(self, *args, **kwargs):
        raise NotImplementedError("step_program arrives with the dispatch A/B "
                                  "slice (eager / per-stage / CUDA-Graph step)")
