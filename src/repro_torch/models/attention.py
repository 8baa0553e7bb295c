"""GQA attention: full-sequence (prefill) and cached decode with
selectable backends (the paper's §6 attention-backend matrix).

Port of ``repro.models.attention``, contiguous caches only.  Backends for
the decode step:
  sdpa     — einsum + softmax written in torch (the reference's own
             fused-softmax route; not ``F.scaled_dot_product_attention``)
  math     — explicitly decomposed softmax (the paper's MATH fallback)
  split_kv — flash-decoding style partitioned KV with partial-softmax
             combine
  cuda     — the hand-written decode-attention kernel
             (kernels/decode_attention); on a CPU tensor its plain version

Unlike the reference, which returns new arrays, the decode path writes
the new K/V row into the cache tensors **in place**.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense_init

Params = Dict[str, torch.Tensor]

DECODE_BACKENDS = ("sdpa", "math", "split_kv", "cuda")

# above this sequence length, full attention runs q-block-chunked (exact
# math): scores never materialise beyond (bq, S).
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_Q = 1024


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, cfg.d_model, hq * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, hkv * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, hkv * hd, dtype),
        "wo": dense_init(gen, hq * hd, cfg.d_model, dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    from repro_torch.quant.paths import matmul
    B, S, _ = x.shape
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k (B,Sk,Hkv,hd) -> scores (B,Hkv,G,Sq,Sk) f32.

    Operands in their own precision, products summed in f32 (the
    reference's ``preferred_element_type=f32``): a bf16 product is exact
    in f32, so an f32 einsum over the upcast operands is the same."""
    B, Sq, Hq, hd = q.shape
    G = Hq // cfg.n_kv_heads
    qg = q.reshape(B, Sq, cfg.n_kv_heads, G, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * (hd ** -0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """probs (B,Hkv,G,Sq,Sk) f32, v (B,Sk,Hkv,hd) -> (B,Sq,Hq*hd) f32.
    The probabilities are rounded to v's dtype first, as the reference
    does."""
    B = probs.shape[0]
    o = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(), v.float())
    Sq = o.shape[1]
    return o.reshape(B, Sq, cfg.n_heads * cfg.head_dim)


def _causal_probs(scores: torch.Tensor, q0: int, S: int,
                  window: Optional[int]) -> torch.Tensor:
    """scores (B,K,G,bq,S) for q rows starting at q0 -> masked softmax."""
    bq = scores.shape[3]
    qpos = q0 + torch.arange(bq, device=scores.device)[:, None]
    kpos = torch.arange(S, device=scores.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, float("-inf"))
    return torch.softmax(scores, dim=-1)


def attention_full(p: Params, x: torch.Tensor, angles: torch.Tensor,
                   cfg: ArchConfig, apply_rope_fn
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full causal attention (prefill). Returns (out, (k, v)).

    Long sequences (> CHUNKED_ATTN_THRESHOLD) run q-block-chunked in a
    Python loop — exact math, (bq, S) score footprint instead of (S, S)."""
    from repro_torch.quant.paths import matmul
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope_fn(q, angles)
    k = apply_rope_fn(k, angles)

    if S <= CHUNKED_ATTN_THRESHOLD:
        probs = _causal_probs(_gqa_scores(q, k, cfg), 0, S, cfg.sliding_window)
        out = _gqa_out(probs, v, cfg).to(x.dtype)
        return matmul(out, p["wo"]), (k, v)

    bq = CHUNK_Q
    if S % bq:
        raise ValueError(f"chunked attention needs S % {bq} == 0, got S={S}")
    blocks = []
    for i in range(S // bq):
        qi = q[:, i * bq:(i + 1) * bq]
        probs = _causal_probs(_gqa_scores(qi, k, cfg), i * bq, S,
                              cfg.sliding_window)
        blocks.append(_gqa_out(probs, v, cfg).to(x.dtype))
    out = torch.cat(blocks, dim=1)
    return matmul(out, p["wo"]), (k, v)


# --------------------------------------------------------------------------
# decode (single new token against a static cache)
# --------------------------------------------------------------------------

def decode_mask(pos: torch.Tensor, s_max: int, *, ring: bool = False) -> torch.Tensor:
    """Valid-slot mask for a decode step, built on pos's device.

    Full cache (s_max >= ctx): slots 0..pos valid.
    Ring cache (sliding window == s_max): slots <= pos valid until the
    ring wraps (pos >= s_max), after which every slot holds an in-window
    token.  Softmax is permutation-invariant over slots, so slot order
    never matters; RoPE was applied at absolute positions on write.

    ``pos`` may be a 0-dim tensor (one shared position, the static-batch
    path) or a (B,) vector of per-slot positions — the latter yields a
    (B, s_max) per-slot length mask.
    """
    idx = torch.arange(s_max, device=pos.device)
    if pos.dim():
        m = idx[None, :] <= pos[:, None]
        if ring:
            m = m | (pos[:, None] >= s_max)
        return m
    m = idx <= pos
    if ring:
        m = m | (pos >= s_max)
    return m


def _kv_write(dst: torch.Tensor, new: torch.Tensor, write_pos: torch.Tensor,
              active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the new (B, 1, ...) row into the cache's sequence axis, **in
    place**; returns ``dst``.

    A 0-dim ``write_pos`` tensor writes every sequence at the same slot
    (static batch); a (B,) vector writes each sequence at its own slot.
    ``active`` (B,) bool turns the write into a per-lane no-op: an
    inactive lane re-writes the row already under its position.  The
    positions stay on the device: nothing here reads them on the host.
    """
    new = new.to(dst.dtype)
    if write_pos.dim() == 0:
        return dst.index_copy_(1, write_pos.reshape(1).long(), new)
    lanes = torch.arange(dst.shape[0], device=dst.device)
    row = new[:, 0]
    if active is not None:
        old = dst[lanes, write_pos]
        shape = (-1,) + (1,) * (row.dim() - 1)
        row = torch.where(active.reshape(shape), row, old)
    dst[lanes, write_pos] = row
    return dst


def _bmask(mask: torch.Tensor, B: int) -> torch.Tensor:
    """Normalise a valid-slot mask to (B, S): a shared (S,) mask
    broadcasts; a (B, S) per-slot mask passes through."""
    if mask.dim() == 2:
        return mask
    return mask[None, :].expand(B, mask.shape[0])


def _sdpa_decode(q, k_cache, v_cache, mask, cfg):
    """``mask`` is (S,) shared or (B, S) per-slot."""
    mask = _bmask(mask, q.shape[0])
    scores = _gqa_scores(q, k_cache.to(q.dtype), cfg)       # (B,K,G,1,S)
    scores = torch.where(mask[:, None, None, None, :], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v_cache.to(q.dtype), cfg)


def _math_decode(q, k_cache, v_cache, mask, cfg):
    """Explicitly decomposed softmax (separate max/exp/sum/div ops)."""
    mask = _bmask(mask, q.shape[0])
    scores = _gqa_scores(q, k_cache, cfg)
    scores = torch.where(mask[:, None, None, None, :], scores, -1e30)
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    z = torch.sum(e, dim=-1, keepdim=True)
    probs = e / z
    return _gqa_out(probs, v_cache, cfg)


def _split_kv_decode(q, k_cache, v_cache, mask, cfg, n_partitions: int = 8):
    """Flash-decoding: partition the KV axis, partial softmax per
    partition, numerically-exact combine (log-sum-exp merge)."""
    mask = _bmask(mask, q.shape[0])
    B, S, Hkv, hd = k_cache.shape
    P = n_partitions
    while S % P:
        P //= 2
    sp = S // P
    ms, ls, accs = [], [], []
    for i in range(P):
        kpi = k_cache[:, i * sp:(i + 1) * sp]
        vpi = v_cache[:, i * sp:(i + 1) * sp]
        mi = mask[:, i * sp:(i + 1) * sp][:, None, None, None, :]
        scores = _gqa_scores(q, kpi, cfg)                    # (B,K,G,1,sp)
        scores = torch.where(mi, scores, float("-inf"))
        m = torch.amax(scores, dim=-1)                       # (B,K,G,1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.exp(scores - m_safe[..., None])
        e = torch.where(mi, e, 0.0)
        ls.append(torch.sum(e, dim=-1))
        accs.append(torch.einsum("bkgqs,bskh->bkgqh", e, vpi.float()))
        ms.append(m)
    ms, ls, accs = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    m_glob = torch.amax(ms, dim=0)
    m_glob_safe = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    scale = torch.exp(torch.where(torch.isfinite(ms), ms - m_glob_safe,
                                  float("-inf")))
    l_glob = torch.sum(ls * scale, dim=0)
    acc = torch.sum(accs * scale[..., None], dim=0)
    out = acc / torch.clamp(l_glob, min=1e-30)[..., None]    # (B,K,G,1,hd)
    B_, K, G, _, hd_ = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B_, 1, K * G * hd_)


def _decode_attend(q, k_read, v_read, mask, cfg: ArchConfig, backend: str,
                   out_dtype, paged=None) -> torch.Tensor:
    """Run the selected decode backend over an (already updated) K/V view.
    This is the ONE place backend routing happens."""
    if paged is not None:
        raise NotImplementedError(
            "paged KV caches arrive with the paged / continuous-batching slice")
    if backend == "sdpa":
        return _sdpa_decode(q, k_read, v_read, mask, cfg).to(out_dtype)
    if backend == "math":
        return _math_decode(q, k_read, v_read, mask, cfg).to(out_dtype)
    if backend == "split_kv":
        return _split_kv_decode(q, k_read, v_read, mask, cfg).to(out_dtype)
    if backend == "cuda":
        from repro_torch.kernels.decode_attention import ops as da_ops
        B = q.shape[0]
        o = da_ops.decode_attention(q[:, 0], k_read, v_read, mask)
        return o.reshape(B, 1, cfg.n_heads * cfg.head_dim).to(out_dtype)
    raise ValueError(f"unknown decode backend {backend!r}")


def attention_decode(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, write_pos: torch.Tensor,
                     mask: torch.Tensor, angles: torch.Tensor, cfg: ArchConfig,
                     apply_rope_fn, backend: str = "sdpa",
                     k_scale=None, v_scale=None, active=None):
    """One-token decode.  x (B,1,D); cache (B,S_max,Hkv,hd).

    ``write_pos`` is the cache slot for the new K/V (== absolute pos for a
    full cache, pos % window for a ring cache), a 0-dim tensor for a
    static batch or (B,) for per-slot positions; ``mask`` (S_max,) or
    (B,S_max) marks valid slots (see ``decode_mask``).  The new K/V row
    is written into ``k_cache``/``v_cache`` in place.

    Returns (out, k_cache, v_cache) — the same cache tensors."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV caches arrive with the int8-KV "
                                  "quantisation slice")
    from repro_torch.quant.paths import matmul
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope_fn(q, angles)
    k_new = apply_rope_fn(k_new, angles)
    _kv_write(k_cache, k_new, write_pos, active)
    _kv_write(v_cache, v_new, write_pos, active)
    out = _decode_attend(q, k_cache, v_cache, mask, cfg, backend, x.dtype)
    return matmul(out, p["wo"]), k_cache, v_cache
