"""Model assembly for all six families (dense / moe / ssm / hybrid /
vlm / audio).

Port of ``repro.models.model`` with the same API, params passed in:

    m = Model(cfg, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    logits, aux = m.forward(params, batch)
    loss, metrics = m.loss(params, batch)            # train (Model(remat=...))
    cache = m.init_cache(batch_size, max_len)        # or slotted / paged,
    logits, cache = m.prefill(params, batch, cache)  # int8 KV
    logits, cache = m.decode_step(params, cache, tokens)

Params are a dict with the reference's keys (``embed``, ``blocks``,
``final_norm``, ``lm_head``, ``shared_attn`` for the hybrid, ``moe`` in
a moe block); ``blocks`` is a Python list of per-layer dicts where the
reference stacks layers on a leading L axis.  The audio family (MusicGen)
stacks its ``n_codebooks`` embedding tables and heads as (K, V, D), sums
the codebooks' embeddings on the way in and returns (B, S, K, V) logits;
the vlm family (Qwen2-VL) takes ``batch["embeds"]`` (B, S, D) and
M-RoPE ``batch["positions"]`` (B, S, 3) at prefill and tokens at decode.
Caches are preallocated and updated **in place**: ``prefill``, the
per-slot prefills, ``copy_kv_page`` and ``decode_step`` write into the
cache they are given and return that same dict, and the position ``pos`` (a 0-dim
device tensor, or a (B,) vector on slotted and paged caches) is advanced
in place, so a decode step reads nothing back to the host and can replay
as a CUDA graph at fixed addresses.  The ssm and hybrid families serve
contiguous batch caches only (their recurrent state ``h`` and conv
window ``conv`` are updated in place too); slotted, paged and int8-KV
caches and active-lane masking raise for them, as in the reference.
The attention families (dense, vlm, audio, moe) take every cache layout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dispatch import StepProgram
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.common import (apply_norm, apply_rope, cross_entropy,
                                       embed_init, embedding, init_mlp,
                                       init_norm, make_angle_fn, mlp_forward)

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


ATTENTION_FAMILIES = ("dense", "vlm", "audio", "moe")
REMAT = ("none", "blocks", "full")
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class Model:
    def __init__(self, cfg: ArchConfig, *, decode_backend: str = "cuda",
                 ssd_chunk: int = mamba2.DEFAULT_CHUNK, device=None,
                 remat: str = "none"):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported yet; the port "
                f"serves the {', '.join(PORTED_FAMILIES)} families")
        if decode_backend not in attn.DECODE_BACKENDS:
            raise ValueError(f"decode_backend must be one of "
                             f"{attn.DECODE_BACKENDS}, got {decode_backend!r}")
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        self.cfg = cfg
        self.decode_backend = decode_backend
        self.ssd_chunk = ssd_chunk
        self.remat = remat   # none | blocks | full (checkpoint each layer body)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products in full f32, as the reference computes them
            # (TF32 keeps about three decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.angle_fn = make_angle_fn(cfg, self.device) if cfg.n_heads else None
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def _maybe_remat(self, body):
        """Block-level rematerialisation (the reference's ``_maybe_remat``):
        with remat "blocks" or "full" under grad mode, a layer body keeps
        only its inputs and recomputes its internals in the backward.
        Non-reentrant checkpointing, without the RNG state: a forward
        draws no random numbers, and reading the RNG state is not allowed
        while a CUDA graph is captured."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return body

        def run(*args):
            return checkpoint(body, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return run

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_block(self, gen: torch.Generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if cfg.family in ("ssm", "hybrid"):
            return {"norm1": init_norm(cfg, dt, dev),
                    "mamba": mamba2.init_mamba(gen, cfg, dt)}
        if cfg.family == "moe":
            return {"norm1": init_norm(cfg, dt, dev),
                    "attn": attn.init_attention(gen, cfg, dt),
                    "norm2": init_norm(cfg, dt, dev),
                    "moe": moe.init_moe(gen, cfg, dt)}
        return self._init_shared_attn(gen)

    def _init_shared_attn(self, gen: torch.Generator) -> Params:
        """An attention + MLP block: a dense layer, or the hybrid's one
        shared block (one set of weights, applied every ``attn_every``
        layers)."""
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

        def tables():
            """One (V, D) table, or (K, V, D): one per audio codebook."""
            if not cfg.n_codebooks:
                return embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
            return torch.stack([embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
                                for _ in range(cfg.n_codebooks)])
        params: Params = {
            "embed": tables(),
            "blocks": [self._init_block(gen) for _ in range(cfg.n_layers)],
            "final_norm": init_norm(cfg, dt, self.device),
        }
        if cfg.family == "hybrid":
            params["shared_attn"] = self._init_shared_attn(gen)
        if not cfg.tie_embeddings:
            params["lm_head"] = tables()
        return params

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def embed_tokens(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.n_codebooks:
            # tokens (B, S, K): the codebooks' embeddings summed left to
            # right, as the reference's functools.reduce(jnp.add, ...)
            x = embedding(tokens[..., 0], params["embed"][0])
            for k in range(1, cfg.n_codebooks):
                x = x + embedding(tokens[..., k], params["embed"][k])
            return x
        return embedding(tokens, params["embed"])

    def lm_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        if self.cfg.n_codebooks:
            return torch.einsum("bsd,kvd->bskv", x, head)
        return x @ head.T

    # ------------------------------------------------------------------
    # forward (prefill backbone)
    # ------------------------------------------------------------------
    def _ffn(self, bp: Params, h, with_aux: bool = False):
        """The block's FFN on the normed stream: (out, aux) — the routed
        MoE (aux: its load-balance loss, or None without ``with_aux``)
        or the MLP (aux 0.0)."""
        if "moe" in bp:
            return moe.moe_forward(bp["moe"], h, self.cfg, with_aux=with_aux)
        return mlp_forward(bp["mlp"], h, self.cfg.mlp_gated), 0.0

    def _attn_block_full(self, bp: Params, x, angles):
        cfg = self.cfg
        a_out, (k, v) = attn.attention_full(bp["attn"], apply_norm(x, bp["norm1"]),
                                            angles, cfg, apply_rope)
        x = x + a_out
        m_out, aux = self._ffn(bp, apply_norm(x, bp["norm2"]), with_aux=True)
        return x + m_out, aux, (k, v)

    def _mamba_block_full(self, bp: Params, x):
        y, h_fin, conv = mamba2.mamba_forward(
            bp["mamba"], apply_norm(x, bp["norm1"]), self.cfg,
            chunk=self.ssd_chunk)
        return x + y, h_fin, conv

    def _positions(self, batch: Dict, B: int, S: int, device):
        pos = batch.get("positions")
        if pos is None:
            return torch.arange(S, device=device)[None, :].expand(B, S)
        return pos.to(device)

    def backbone(self, params: Params, batch: Dict, *, collect_cache: bool = False):
        """Full-sequence backbone over ``batch["tokens"]`` (B, S), or
        (B, S, K) with audio codebooks, or ``batch["embeds"]`` (B, S, D)
        in their place (vlm: precomputed patch and text embeddings, cast
        to the model dtype), at ``batch["positions"]`` when given ((B,
        S, 3) t/h/w ids for M-RoPE), else 0..S-1.  Returns (hidden, aux,
        layer_caches); aux sums the moe layers' load-balance losses (0.0
        for the other families).  With ``collect_cache``, layer_caches is
        a list of per-layer (k, v) (attention families), of per-layer
        (h, conv) (ssm), or ``(states, kvs)`` with one (k, v) per
        application of the shared block (hybrid)."""
        cfg = self.cfg
        x = batch.get("embeds")
        if x is None:
            x = self.embed_tokens(params, batch["tokens"])
        else:
            x = x.to(device=self.device, dtype=self.dtype)
        B, S = x.shape[0], x.shape[1]
        angles = (self.angle_fn(self._positions(batch, B, S, x.device))
                  if self.angle_fn else None)
        if cfg.family == "hybrid":
            return self._hybrid_backbone(params, x, angles, collect_cache)
        caches = []
        aux = 0.0
        attn_body = self._maybe_remat(self._attn_block_full)
        mamba_body = self._maybe_remat(self._mamba_block_full)
        for bp in params["blocks"]:
            if cfg.family == "ssm":
                x, h_fin, conv = mamba_body(bp, x)
                layer_cache = (h_fin, conv)
            else:
                x, aux_l, layer_cache = attn_body(bp, x, angles)
                aux = aux + aux_l
            if collect_cache:
                caches.append(layer_cache)
        return x, aux, (caches if collect_cache else None)

    def _hybrid_groups(self):
        """(first, end) layer ranges; the shared block runs before each."""
        cfg = self.cfg
        ae = cfg.attn_every
        return [(s, min(s + ae, cfg.n_layers))
                for s in range(0, cfg.n_layers, ae)]

    def _hybrid_backbone(self, params, x, angles, collect_cache):
        cfg = self.cfg
        sp = params["shared_attn"]
        states, kvs = [], []
        # only the mamba bodies are rematerialised, as in the reference
        mamba_body = self._maybe_remat(self._mamba_block_full)
        for g0, g1 in self._hybrid_groups():
            x, _, kv = self._attn_block_full(sp, x, angles)
            kvs.append(kv)
            for bp in params["blocks"][g0:g1]:
                x, h_fin, conv = mamba_body(bp, x)
                states.append((h_fin, conv))
        return x, 0.0, ((states, kvs) if collect_cache else None)

    def forward(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, Any]:
        x, aux, _ = self.backbone(params, batch)
        x = apply_norm(x, params["final_norm"])
        return self.lm_logits(params, x), aux

    def loss(self, params: Params, batch: Dict, *, aux_weight: float = 0.01,
             z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"loss", "ce", "aux"}): the next-token cross-entropy of
        ``batch["labels"]`` plus aux_weight times the moe load-balance
        loss (0 for the other families), each a 0-dim f32 tensor on the
        model's device."""
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"], z_loss)
        if not torch.is_tensor(aux):   # 0.0: no moe layer
            aux = torch.full((), float(aux), dtype=torch.float32, device=ce.device)
        total = ce + aux_weight * aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int, kv_dtype=None,
                   slotted: bool = False, paged: bool = False,
                   page_size: int = 16, n_pages: Optional[int] = None
                   ) -> Cache:
        """KV cache on the model's device, zeros.

        Contiguous: ``k``/``v`` (L, B, kv_len, Hkv, hd) with ``pos`` a
        0-dim int32 tensor; with a sliding window kv_len = min(max_len,
        window) and the cache is a ring.  ``slotted=True`` makes ``pos``
        a (B,) vector of per-slot positions (continuous batching: each
        row is an independent session slot).

        ``paged=True`` (implies slotted) replaces the per-slot rows with
        a page pool plus a per-slot block table: ``k``/``v`` (L, n_pages,
        page_size, Hkv, hd) and ``block_table`` (B, max_blocks) int32.
        Page 0 is the garbage sentinel (never allocated; free lanes point
        at it).  ``n_pages`` defaults to full backing, 1 + B *
        max_blocks; fewer oversubscribes the pool.

        ``kv_dtype`` defaults to the model dtype; ``torch.int8`` stores
        int8 codes plus per-(token, head) f32 scales ``k_scale`` /
        ``v_scale``, shaped like ``k`` without head_dim; on a paged cache
        they share the block table.

        ssm and hybrid (contiguous only): the recurrent state ``h`` (L, B,
        H, P, N) f32 and conv window ``conv`` (L, B, K-1, conv_ch) in the
        model dtype; the hybrid adds ``k``/``v`` (n_apps, B, kv_len, Hkv,
        hd), one row per application of the shared block."""
        cfg = self.cfg
        kv_dtype = kv_dtype or self.dtype
        dev = self.device
        if cfg.family not in ATTENTION_FAMILIES:
            if slotted or paged:
                raise NotImplementedError(
                    "slotted (continuous-batching) caches target the "
                    f"attention families, got {cfg.family!r}")
            if kv_dtype == torch.int8:
                raise NotImplementedError(
                    f"int8 KV targets the attention families, got "
                    f"{cfg.family!r}")
            return self._init_state_cache(batch_size, max_len, kv_dtype)
        if paged:
            if cfg.sliding_window:
                raise NotImplementedError(
                    "paged KV + sliding-window (ring) caches not supported")
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            max_blocks = -(-max_len // page_size)
            if n_pages is None:
                n_pages = 1 + batch_size * max_blocks   # full backing
            if n_pages < 2:
                raise ValueError("need the garbage page plus >= 1 real page")
            shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                     cfg.head_dim)
            cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                     "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
                     "pos": torch.zeros((batch_size,), dtype=torch.int32,
                                        device=dev),
                     "block_table": torch.zeros((batch_size, max_blocks),
                                                dtype=torch.int32, device=dev)}
        else:
            kv_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                      else max_len)
            shape = (cfg.n_layers, batch_size, kv_len, cfg.n_kv_heads,
                     cfg.head_dim)
            pos_shape = (batch_size,) if slotted else ()
            cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                     "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
                     "pos": torch.zeros(pos_shape, dtype=torch.int32,
                                        device=dev)}
        if kv_dtype == torch.int8:
            cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
            cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
        return cache

    def _init_state_cache(self, batch_size: int, max_len: int,
                          kv_dtype) -> Cache:
        cfg, dev = self.cfg, self.device
        L, B = cfg.n_layers, batch_size
        cache = {
            "h": torch.zeros((L, B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32, device=dev),
            "conv": torch.zeros((L, B, cfg.ssm_conv - 1, cfg.conv_channels),
                                dtype=self.dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if cfg.family == "hybrid":
            kv_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                      else max_len)
            shape = (len(self._hybrid_groups()), B, kv_len, cfg.n_kv_heads,
                     cfg.head_dim)
            cache["k"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
            cache["v"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
        return cache

    @staticmethod
    def _page_slab_keys(cache: Cache) -> Tuple[str, ...]:
        """Cache keys indexed (L, n_pages, ...) — everything a page id
        addresses.  Quantised pools carry scale slabs alongside codes."""
        if "k_scale" in cache:
            return ("k", "v", "k_scale", "v_scale")
        return ("k", "v")

    def copy_kv_page(self, cache: Cache, src: int, dst: int) -> Cache:
        """Copy one pool page — every layer's K and V rows, and scales —
        onto another, in place: the copy-on-write fault of prefix
        sharing.  Returns the same cache."""
        if "block_table" not in cache:
            raise ValueError("copy_kv_page targets paged caches")
        for key in self._page_slab_keys(cache):
            cache[key][:, dst].copy_(cache[key][:, src])
        return cache

    def save_kv_pages(self, cache: Cache, pages: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
        """Gather ``pages`` (a (P,) id vector) out of the paged pool —
        every layer's K and V rows — as new (L, P, page, ...) slabs: the
        device-to-host half of KV-page tiering (serving/memory/tiers.py).
        One slab per page-indexed pool: (k, v), or (k, v, k_scale,
        v_scale) for int8 KV, so codes and scales move together,
        bit-exact.  The pool is only read."""
        if "block_table" not in cache:
            raise ValueError("save_kv_pages targets paged caches")
        pages = pages.to(cache["k"].device)
        return tuple(cache[key].index_select(1, pages)
                     for key in self._page_slab_keys(cache))

    def restore_kv_pages(self, cache: Cache, pages: torch.Tensor,
                         *slabs: torch.Tensor) -> Cache:
        """Write saved slabs back into pool ``pages``, in place — the
        host-to-device half of tiering.  ``slabs`` follow
        ``save_kv_pages``' order; ``pages`` must not repeat.  Unlike the
        reference, which returns a new cache, the pools keep their
        tensors: a captured decode graph reads them at fixed addresses.
        Returns the same cache."""
        if "block_table" not in cache:
            raise ValueError("restore_kv_pages targets paged caches")
        keys = self._page_slab_keys(cache)
        if len(slabs) != len(keys):
            raise ValueError(f"restore_kv_pages takes {len(keys)} slabs "
                             f"({keys}), got {len(slabs)}")
        pages = pages.to(cache["k"].device)
        for key, slab in zip(keys, slabs):
            cache[key].index_copy_(1, pages, slab.to(cache[key].dtype))
        return cache

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def prefill(self, params: Params, batch: Dict, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
        """Populate a contiguous cache from a full prompt, in place;
        returns the last-position logits and the same cache."""
        from repro_torch.quant import kv as kvq
        cfg = self.cfg
        x, _, caches = self.backbone(params, batch, collect_cache=True)
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

        kvs = caches
        if cfg.family in ("ssm", "hybrid"):
            states, kvs = (caches, []) if cfg.family == "ssm" else caches
            for i, (h, conv) in enumerate(states):
                cache["h"][i].copy_(h)
                cache["conv"][i].copy_(conv)
        quantized = "k_scale" in cache
        for i, (k, v) in enumerate(kvs):
            if quantized:
                (kq, ks), (vq, vs) = kvq.quantize_kv_write(k), kvq.quantize_kv_write(v)
                place(kq, cache["k"][i])
                place(vq, cache["v"][i])
                place(ks, cache["k_scale"][i])
                place(vs, cache["v_scale"][i])
            else:
                place(k, cache["k"][i])
                place(v, cache["v"][i])
        cache["pos"].fill_(S)
        x_last = apply_norm(x[:, -1:], params["final_norm"])
        return self.lm_logits(params, x_last), cache

    def prefill_into_slot(self, params: Params, batch: Dict, cache: Cache,
                          slot: int) -> Tuple[torch.Tensor, Cache]:
        """Prefill ONE session (batch-1 prompt) into one slot of a slotted
        cache, in place: K/V land at positions 0..S-1 of the slot's row
        and ``pos[slot] = S``.  Stale K/V past S from an earlier occupant
        stay masked out by the per-slot length mask until overwritten.
        A paged cache takes the whole prompt as one chunk.  Returns the
        last-position logits (1, 1, V) and the same cache."""
        from repro_torch.quant import kv as kvq
        if self.cfg.family not in ATTENTION_FAMILIES:
            raise NotImplementedError(
                f"prefill_into_slot targets attention families, got "
                f"{self.cfg.family!r}")
        if "block_table" in cache:
            return self.prefill_chunk_into_slot(params, batch, cache, slot, 0)
        n, S = next(iter(batch.values())).shape[:2]
        if n != 1 or S > cache["k"].shape[2]:
            raise ValueError(f"prefill_into_slot takes a batch-1 prompt of at "
                             f"most {cache['k'].shape[2]} tokens; got {(n, S)}")
        x, _, kvs = self.backbone(params, batch, collect_cache=True)
        for i, (k, v) in enumerate(kvs):
            if "k_scale" in cache:
                k, ks = kvq.quantize_kv_write(k)
                v, vs = kvq.quantize_kv_write(v)
                cache["k_scale"][i, slot, :S].copy_(ks[0])
                cache["v_scale"][i, slot, :S].copy_(vs[0])
            cache["k"][i, slot, :S].copy_(k[0])
            cache["v"][i, slot, :S].copy_(v[0])
        cache["pos"][slot] = S
        x_last = apply_norm(x[:, -1:], params["final_norm"])
        return self.lm_logits(params, x_last), cache

    def prefill_chunk_into_slot(self, params: Params, batch: Dict,
                                cache: Cache, slot: int, start_pos: int
                                ) -> Tuple[torch.Tensor, Cache]:
        """Prefill one CHUNK of a session's prompt into a paged cache, in
        place.  ``batch["tokens"]`` is (1, C): chunk tokens at absolute
        positions ``start_pos .. start_pos + C - 1``; ``start_pos`` must
        be page-aligned.  The chunk attends over the session's cached
        prefix plus itself (exact math, see ``attention_prefill_paged``),
        so a prompt fed chunk by chunk is token-identical to one whole
        prefill.  Sets ``pos[slot] = start_pos + C``; returns the chunk's
        last-position logits (1, 1, V) and the same cache."""
        cfg = self.cfg
        if "block_table" not in cache:
            raise ValueError("prefill_chunk_into_slot needs a paged cache")
        tokens = batch["tokens"]
        if tokens.shape[0] != 1:
            raise ValueError("chunk prefill takes one session")
        page_size = cache["k"].shape[2]
        if start_pos % page_size:
            raise ValueError(f"start_pos {start_pos} is not page-aligned")
        x = self.embed_tokens(params, tokens)
        C = x.shape[1]
        positions = start_pos + torch.arange(C, device=x.device)[None, :]
        angles = self.angle_fn(positions)
        slot_pages = cache["block_table"][slot]
        quantized = "k_scale" in cache
        for i, bp in enumerate(params["blocks"]):
            a_out = attn.attention_prefill_paged(
                bp["attn"], apply_norm(x, bp["norm1"]), cache["k"][i],
                cache["v"][i], slot_pages, start_pos, angles, cfg, apply_rope,
                k_scale_pool=cache["k_scale"][i] if quantized else None,
                v_scale_pool=cache["v_scale"][i] if quantized else None)
            x = x + a_out
            x = x + self._ffn(bp, apply_norm(x, bp["norm2"]))[0]
        cache["pos"][slot] = start_pos + C
        x_last = apply_norm(x[:, -1:], params["final_norm"])
        return self.lm_logits(params, x_last), cache

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _attn_block_decode(self, bp, x, k_cache, v_cache, write_pos, mask,
                           angles, k_scale=None, v_scale=None, active=None):
        cfg = self.cfg
        a_out = attn.attention_decode(
            bp["attn"], apply_norm(x, bp["norm1"]), k_cache, v_cache,
            write_pos, mask, angles, cfg, apply_rope,
            backend=self.decode_backend, k_scale=k_scale, v_scale=v_scale,
            active=active)
        x = x + a_out
        return x + self._ffn(bp, apply_norm(x, bp["norm2"]))[0]

    def _mamba_block_decode(self, bp, x, h, conv):
        y, _, _ = mamba2.mamba_decode_step(
            bp["mamba"], apply_norm(x, bp["norm1"]), h, conv, self.cfg)
        return x + y

    def _attn_block_decode_paged(self, bp, x, k_pool, v_pool, block_table,
                                 pos, mask, angles, active=None,
                                 k_scale_pool=None, v_scale_pool=None):
        cfg = self.cfg
        a_out = attn.attention_decode_paged(
            bp["attn"], apply_norm(x, bp["norm1"]), k_pool, v_pool,
            block_table, pos, mask, angles, cfg, apply_rope,
            backend=self.decode_backend, active=active,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
        x = x + a_out
        return x + self._ffn(bp, apply_norm(x, bp["norm2"]))[0]

    # staticcheck: hotpath
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One new token per sequence.  tokens (B,1), or (B,1,K) with audio
        codebooks (logits (B,1,K,V)).

        Writes each layer's new K/V row into the cache and advances
        ``cache["pos"]``, all in place; returns (logits (B,1,V), the same
        cache).  On a slotted cache every sequence advances at its own
        position; on a paged cache the row goes through the block table
        and the model's ``decode_backend`` picks the route (``"cuda"``:
        the paged kernel reading pages in place; anything else: the
        gathered view).  ``active`` (B,) bool (slotted caches only)
        turns inactive lanes into no-ops: their K/V write is clamped
        (contiguous: the old row is rewritten; paged: redirected to the
        garbage page) and their position does not advance.  The mask and
        the write slot are computed on the device from ``pos``: the step
        reads nothing back to the host.

        ssm: every layer's state and conv window are updated in place (the
        SSD core through the SSD-update kernel on the card).  hybrid: the
        shared block runs before each group of ``attn_every`` Mamba2
        layers, on its application's row of the contiguous KV cache."""
        cfg = self.cfg
        pos = cache["pos"]
        slotted = pos.dim() == 1
        paged = "block_table" in cache
        if active is not None and (not slotted
                                   or cfg.family not in ATTENTION_FAMILIES):
            raise NotImplementedError("active-lane masking targets slotted "
                                      "caches of the attention families")
        x = self.embed_tokens(params, tokens)
        B = x.shape[0]
        if cfg.family == "ssm":
            for i, bp in enumerate(params["blocks"]):
                x = self._mamba_block_decode(bp, x, cache["h"][i],
                                             cache["conv"][i])
            return self._decode_head(params, cache, x, active)
        if paged:
            kv_len = cache["block_table"].shape[1] * cache["k"].shape[2]
            ring, write_pos = False, pos
        else:
            kv_len = cache["k"].shape[2]
            ring = bool(cfg.sliding_window) and kv_len <= cfg.sliding_window
            write_pos = pos % kv_len if ring else pos
        mask = attn.decode_mask(pos, kv_len, ring=ring)
        positions = pos[:, None] if slotted else pos.reshape(1, 1).expand(B, 1)
        angles = self.angle_fn(positions)
        if cfg.family == "hybrid":
            for a, (g0, g1) in enumerate(self._hybrid_groups()):
                x = self._attn_block_decode(params["shared_attn"], x,
                                            cache["k"][a], cache["v"][a],
                                            write_pos, mask, angles)
                for i in range(g0, g1):
                    x = self._mamba_block_decode(params["blocks"][i], x,
                                                 cache["h"][i], cache["conv"][i])
            return self._decode_head(params, cache, x, active)
        quantized = "k_scale" in cache
        for i, bp in enumerate(params["blocks"]):
            scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quantized
                      else (None, None))
            if paged:
                x = self._attn_block_decode_paged(
                    bp, x, cache["k"][i], cache["v"][i], cache["block_table"],
                    pos, mask, angles, active, *scales)
            else:
                x = self._attn_block_decode(bp, x, cache["k"][i], cache["v"][i],
                                            write_pos, mask, angles, *scales,
                                            active=active)
        return self._decode_head(params, cache, x, active)

    def _decode_head(self, params: Params, cache: Cache, x, active):
        """Advance the positions in place; final norm and logits."""
        pos = cache["pos"]
        if active is None:
            pos.add_(1)
        else:
            pos.add_(active.to(pos.dtype))
        x = apply_norm(x, params["final_norm"])
        return self.lm_logits(params, x), cache

    # staticcheck: hotpath
    def decode_steps(self, params: Params, cache: Cache, tokens: torch.Tensor,
                     gen: Optional[torch.Generator] = None,
                     steps_left: Optional[torch.Tensor] = None, *,
                     horizon: int, temperature: float = 0.0, top_k: int = 0,
                     eos_id: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Cache]:
        """Advance every sequence up to ``horizon`` tokens with on-device
        sampling (greedy argmax, or categorical draws from ``gen``),
        returning the token matrix (B, horizon) — (B, horizon, K) with
        audio codebooks — without reading anything back to the host.

        ``steps_left`` (B,) int32 caps each lane's real steps (slotted
        caches): a lane stops being active once its budget is spent or,
        with ``eos_id``, once it samples EOS; after that its cache writes
        are no-ops, its position freezes and its emitted tokens repeat
        the last real one (the host trims them); it raises with audio
        codebooks, as the reference does.  Greedy streams are
        token-identical to ``horizon`` single ``decode_step`` calls."""
        from repro_torch.serving.sampling import sample
        masked = steps_left is not None
        if masked and self.cfg.n_codebooks:
            raise NotImplementedError(
                "steps_left masking serves single-codebook archs")
        if eos_id is not None and not masked:
            raise NotImplementedError("eos_id requires steps_left masking")
        toks = []
        tok = tokens
        alive = torch.ones((tokens.shape[0],), dtype=torch.bool,
                           device=tokens.device)
        for step in range(horizon):
            active = (alive & (step < steps_left)) if masked else None
            logits, cache = self.decode_step(params, cache, tok, active=active)
            nxt = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
            if masked:
                nxt = torch.where(active, nxt, tok[:, 0])
                if eos_id is not None:
                    alive = alive & ~(active & (nxt == eos_id))
            toks.append(nxt)
            tok = nxt[:, None]
        return torch.stack(toks, dim=1), cache

    # ------------------------------------------------------------------
    # dispatch A/B decomposition (paper §5)
    # ------------------------------------------------------------------
    def step_program(self, params: Params, cache: Cache) -> StepProgram:
        """Decompose ``decode_step`` into [embed] + [block_i]* + [head]
        stages over a state dict, for the eager / stage_jit / full_jit
        A/B.  Attention families only (the A/B targets the paper's
        models), on contiguous and slotted caches.

        The stages run ``decode_step``'s kernels in its order: the embed
        stage also computes the step's mask, write slot (``pos % kv_len``
        once a sliding-window ring wraps) and RoPE angles once, carried
        in the state as ``mask``, ``write_pos`` and ``angles``; each
        block writes its K/V row (and int8 scales) in place; the head
        advances ``pos`` in place and adds ``logits``.  So the A/B
        touches the launch term and only the launch term."""
        cfg = self.cfg
        if cfg.family not in ATTENTION_FAMILIES:
            raise NotImplementedError(
                f"step_program decomposes the attention families' step, got "
                f"{cfg.family!r}; the engine captures the whole step")
        if cache is not None and "block_table" in cache:
            raise NotImplementedError(
                "step_program does not decompose the paged decode step; "
                "paged serving runs the full_jit arm only")

        def embed_stage(state):
            x = self.embed_tokens(params, state["tokens"])
            pos = state["cache"]["pos"]
            kv_len = state["cache"]["k"].shape[2]
            ring = bool(cfg.sliding_window) and kv_len <= cfg.sliding_window
            positions = (pos[:, None] if pos.dim() == 1
                         else pos.reshape(1, 1).expand(x.shape[0], 1))
            return dict(state, x=x, write_pos=pos % kv_len if ring else pos,
                        mask=attn.decode_mask(pos, kv_len, ring=ring),
                        angles=self.angle_fn(positions))

        def make_block_stage(i):
            bp = params["blocks"][i]

            def stage(state):
                c = state["cache"]
                scales = ((c["k_scale"][i], c["v_scale"][i]) if "k_scale" in c
                          else (None, None))
                x = self._attn_block_decode(bp, state["x"], c["k"][i], c["v"][i],
                                            state["write_pos"], state["mask"],
                                            state["angles"], *scales)
                return dict(state, x=x)
            return stage

        def head_stage(state):
            logits, _ = self._decode_head(params, state["cache"], state["x"], None)
            return dict(state, logits=logits)

        stages = [embed_stage] + [make_block_stage(i) for i in range(cfg.n_layers)] \
            + [head_stage]
        return StepProgram(stages)
