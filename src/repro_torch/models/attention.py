"""GQA attention: full-sequence (prefill) and cached decode with
selectable backends (the paper's §6 attention-backend matrix).

Port of ``repro.models.attention``: contiguous, slotted and paged
caches, each with bf16/f32 or int8 KV.  Backends for the decode step:
  sdpa     — einsum + softmax written in torch (the reference's own
             fused-softmax route; not ``F.scaled_dot_product_attention``);
             on an int8 contiguous cache it folds the scales into the
             scores and probabilities
  math     — explicitly decomposed softmax (the paper's MATH fallback)
  split_kv — flash-decoding style partitioned KV with partial-softmax
             combine
  cuda     — the hand-written kernels: decode attention over a
             contiguous cache (kernels/decode_attention) and, on a paged
             cache, paged decode attention reading pages in place
             (kernels/paged_decode_attention); on a CPU tensor their
             plain versions.  Every other backend runs over the
             gathered ``paged_view`` of a paged cache.

Unlike the reference, which returns new arrays, the decode and paged
prefill paths write the new K/V rows (and int8 scales) into the cache
tensors **in place**.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import _dtensor as _dt
from repro_torch.launch import hints
from repro_torch.models.common import dense_init

Params = Dict[str, torch.Tensor]

DECODE_BACKENDS = ("sdpa", "math", "split_kv", "cuda")

# above this sequence length, full attention runs q-block-chunked (exact
# math): scores never materialise beyond (bq, S).  configure() lets
# launchers (the dry run's policy) retune them.
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_Q = 1024


def configure(threshold: Optional[int] = None, chunk_q: Optional[int] = None):
    global CHUNKED_ATTN_THRESHOLD, CHUNK_Q
    if threshold is not None:
        CHUNKED_ATTN_THRESHOLD = threshold
    if chunk_q is not None:
        CHUNK_Q = chunk_q


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
    def heads(t, n):
        t = _dt.split_dim(t, -1, n).reshape(B, S, n, cfg.head_dim)
        return hints.constrain(t, ("dp", None, "tp"))
    return heads(q, cfg.n_heads), heads(k, cfg.n_kv_heads), heads(v, cfg.n_kv_heads)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k (B,Sk,Hkv,hd) -> scores (B,Hkv,G,Sq,Sk) f32.

    Operands in their own precision, products summed in f32 (the
    reference's ``preferred_element_type=f32``).  The route is chosen by
    device and dtype alone (``_on_tensor_cores``): bf16 or f16 operands
    on the card multiply on the tensor cores with an f32 result
    (``_BmmF32``); anything else (the CPU, which has no
    ``aten::bmm.dtype``, f32 operands, the dry run's meta tensors) runs
    an f32 einsum over the upcast operands, which is the same function
    up to summation order, since a bf16 product is exact in f32.
    DTensors: each rank's batch rows, query rows and KV heads (with
    their query heads), the keys and head_dim gathered
    (``_dtensor.local_call``); DTensor's own einsum would flatten two
    split dims, which it refuses."""
    if _dt.any_dtensor(q, k):
        return _dt.local_call(_gqa_scores_local, [(q, "bqh."), (k, "b.h.")],
                              ["bhgq."])
    return _gqa_scores_local(q, k)


def _on_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a contraction of a and b takes ``_BmmF32``: both CUDA
    tensors of one 16-bit float dtype."""
    return (a.device.type == "cuda" and a.dtype == b.dtype
            and a.dtype in (torch.bfloat16, torch.float16))


class _BmmF32(torch.autograd.Function):
    """a (N,M,K) @ b (N,K,P) in their own 16-bit dtype with an f32
    result (``torch.bmm(out_dtype=torch.float32)``: cuBLAS on the tensor
    cores, f32 accumulation).  Torch gives ``aten::bmm.dtype`` no
    derivative, so the backward is written here: the two transposed
    products of the same kind, the f32 output gradient rounded to the
    operands' dtype first, the gradients returned in it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.transpose(1, 2), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.transpose(1, 2), g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def _gqa_scores_local(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    if not _on_tensor_cores(q, k):
        return torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * (hd ** -0.5)
    # (B*Hkv, G*Sq, hd) @ (B*Hkv, hd, Sk)
    a = qg.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * Sq, hd)
    b = k.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, hd).transpose(1, 2)
    s = _BmmF32.apply(a, b)
    return s.view(B, Hkv, G, Sq, Sk) * (hd ** -0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """probs (B,Hkv,G,Sq,Sk) f32, v (B,Sk,Hkv,hd) -> (B,Sq,Hq*hd) f32.
    The probabilities are rounded to v's dtype first, as the reference
    does; the route and DTensors as in ``_gqa_scores``."""
    if _dt.any_dtensor(probs, v):
        return _dt.local_call(_gqa_out_local, [(probs, "bhgq."), (v, "b.h.")],
                              ["bqh"])
    return _gqa_out_local(probs, v)


def _gqa_out_local(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    p = probs.to(v.dtype)
    if not _on_tensor_cores(p, v):
        o = torch.einsum("bkgqs,bskh->bqkgh", p.float(), v.float())
        B, Sq = o.shape[:2]
        return o.reshape(B, Sq, -1)
    B, Hkv, G, Sq, Sk = p.shape
    hd = v.shape[-1]
    # (B*Hkv, G*Sq, Sk) @ (B*Hkv, Sk, hd)
    o = _BmmF32.apply(p.reshape(B * Hkv, G * Sq, Sk),
                      v.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, hd))
    return o.view(B, Hkv, G, Sq, hd).permute(0, 3, 1, 2, 4).reshape(B, Sq, -1)


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
        # prefer kv-head TP; context-parallel (query-seq) fallback for
        # head counts that don't divide the model axis
        scores = hints.constrain_first_fit(
            _gqa_scores(q, k, cfg), [("dp", "tp"), ("dp", None, None, "tp")])
        probs = _causal_probs(scores, 0, S, cfg.sliding_window)
        out = _heads_split(_gqa_out(probs, v, cfg).to(x.dtype))
        return matmul(out, p["wo"]), (k, v)

    bq = CHUNK_Q
    if S % bq:
        raise ValueError(f"chunked attention needs S % {bq} == 0, got S={S}")
    blocks = []
    for i in range(S // bq):
        qi = q[:, i * bq:(i + 1) * bq]
        scores = hints.constrain_first_fit(
            _gqa_scores(qi, k, cfg), [("dp", "tp"), ("dp", None, None, "tp")])
        probs = _causal_probs(scores, i * bq, S, cfg.sliding_window)
        blocks.append(_gqa_out(probs, v, cfg).to(x.dtype))
    out = _heads_split(torch.cat(blocks, dim=1))
    return matmul(out, p["wo"]), (k, v)


def _heads_split(out: torch.Tensor) -> torch.Tensor:
    """The attention output (B, S, Hq*hd) with its heads over ``tp``, as
    q's were: under the query-sequence fallback of the scores' hint a
    DTensor output comes back split over S, which ``wo``'s matmul would
    flatten into its rows (torch 2.11's DTensor refuses to flatten a
    split inner dim).  A no-op without a mesh."""
    return hints.constrain(out, ("dp", None, "tp"))


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
    A DTensor ``dst`` takes ``_kv_write_sharded``.
    """
    if _dt.is_dtensor(dst):
        return _kv_write_sharded(dst, new, write_pos, active)
    new = new.to(dst.dtype)
    if write_pos.dim() == 0:
        return dst.index_copy_(1, write_pos.reshape(1).long(), new)
    # a free slot's position keeps advancing under K=1 stepping; clamp it
    # into the row as the reference's dynamic_update_slice does
    write_pos = write_pos.clamp(max=dst.shape[1] - 1)
    lanes = torch.arange(dst.shape[0], device=dst.device)
    row = new[:, 0]
    if active is not None:
        old = dst[lanes, write_pos]
        shape = (-1,) + (1,) * (row.dim() - 1)
        row = torch.where(active.reshape(shape), row, old)
    dst[lanes, write_pos] = row
    return dst


def _kv_write_sharded(dst, new, write_pos: torch.Tensor,
                      active: Optional[torch.Tensor]):
    """``_kv_write`` into a DTensor cache (B, S, ...), in place, on each
    rank's shard: a cache split over the sequence (``cache_shardings``)
    has each rank own S / n consecutive slots, and a rank writes the row
    only where the position falls in its slots (an in-place write keeps
    the cache's layout, so nothing is gathered).  The new row, the
    positions and ``active`` are sliced to the rank's lanes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dst.device_mesh
    sizes = mesh.mesh.shape
    S = dst.shape[1]
    off, _ = _dt.shard_span(dst, 1)

    def local(t, rows_only: bool):
        if t is None:
            return None
        if not _dt.is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * len(sizes),
                                   run_check=False)
        want = [p if isinstance(p, Shard) and p.dim != 1
                and (p.dim == 0 or not rows_only) and t.dim() > 0
                else Replicate() for p in dst.placements]
        return t.redistribute(mesh, want).to_local()
    dl = dst.to_local()
    n = dl.shape[1]
    row = local(new, False).to(dl.dtype)
    if write_pos.dim() == 0:
        at = local(write_pos, True) - off
        inside = (at >= 0) & (at < n)
        idx = at.clamp(0, n - 1).reshape(1).long()
        dl.index_copy_(1, idx, torch.where(inside, row, dl.index_select(1, idx)))
        return dst
    at = local(write_pos.clamp(max=S - 1), True) - off
    keep = (at >= 0) & (at < n)
    if active is not None:
        keep = keep & local(active, True)
    at = at.clamp(0, n - 1)
    lanes = torch.arange(dl.shape[0], device=dl.device)
    old = dl[lanes, at]
    shape = (-1,) + (1,) * (old.dim() - 1)
    dl[lanes, at] = torch.where(keep.reshape(shape), row[:, 0], old)
    return dst


def _bmask(mask: torch.Tensor, B: int) -> torch.Tensor:
    """Normalise a valid-slot mask to (B, S): a shared (S,) mask
    broadcasts; a (B, S) per-slot mask passes through."""
    if mask.dim() == 2:
        return mask
    return mask[None, :].expand(B, mask.shape[0])


def _sdpa_decode(q, k_cache, v_cache, mask, cfg, k_scale=None, v_scale=None):
    """k_scale/v_scale (B,S,Hkv): int8-KV path.  The per-token scales are
    constant over head_dim, so they fold into the score and probability
    tensors exactly: no dequantised K/V copy is made.

    ``mask`` is (S,) shared or (B, S) per-slot."""
    mask = _bmask(mask, q.shape[0])
    scores = _gqa_scores(q, k_cache.to(q.dtype), cfg)       # (B,K,G,1,S)
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = torch.where(mask[:, None, None, None, :], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
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
                   out_dtype, k_scale=None, v_scale=None,
                   paged=None) -> torch.Tensor:
    """Run the selected decode backend over an (already updated) K/V view.
    This is the ONE place backend routing happens.

    ``paged`` is the ``(k_pool, v_pool, block_table, lengths)`` tuple of
    a paged cache (``k_read``/``v_read`` are None then), or the 6-tuple
    ``(..., k_scale_pool, v_scale_pool)`` of an int8 pool: ``cuda`` runs
    the paged kernel, which reads pages in place through the block table
    and dequantises int8 codes in registers; every other backend runs
    over the gathered ``paged_view`` (a dequantised model-dtype view of
    an int8 pool)."""
    if paged is not None:
        k_pool, v_pool, block_table, lengths = paged[:4]
        ks_pool, vs_pool = paged[4:] if len(paged) == 6 else (None, None)
        if backend == "cuda":
            from repro_torch.kernels.paged_decode_attention import ops as pda_ops
            B = q.shape[0]
            o = pda_ops.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                               block_table, lengths,
                                               ks_pool, vs_pool)
            return o.reshape(B, 1, cfg.n_heads * cfg.head_dim).to(out_dtype)
        if ks_pool is not None:
            from repro_torch.quant import kv as kvq
            k_read = kvq.dequantize_kv(paged_view(k_pool, block_table),
                                       paged_view(ks_pool, block_table),
                                       out_dtype)
            v_read = kvq.dequantize_kv(paged_view(v_pool, block_table),
                                       paged_view(vs_pool, block_table),
                                       out_dtype)
        else:
            k_read = paged_view(k_pool, block_table)
            v_read = paged_view(v_pool, block_table)
    if backend == "sdpa":
        return _sdpa_decode(q, k_read, v_read, mask, cfg,
                            k_scale=k_scale, v_scale=v_scale).to(out_dtype)
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
                     k_scale=None, v_scale=None, active=None) -> torch.Tensor:
    """One-token decode.  x (B,1,D); cache (B,S_max,Hkv,hd).

    ``write_pos`` is the cache slot for the new K/V (== absolute pos for a
    full cache, pos % window for a ring cache), a 0-dim tensor for a
    static batch or (B,) for per-slot positions; ``mask`` (S_max,) or
    (B,S_max) marks valid slots (see ``decode_mask``).  k_scale/v_scale
    (B,S_max,Hkv) select the int8 cache (``repro_torch.quant.kv``).
    ``active`` (B,) bool makes inactive lanes' writes no-ops.  The new
    K/V row (codes and scales on int8) is written into the cache tensors
    in place.  Returns the attention output (B,1,D)."""
    from repro_torch.quant import kv as kvq
    from repro_torch.quant.paths import matmul
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope_fn(q, angles)
    k_new = apply_rope_fn(k_new, angles)
    quantized = k_scale is not None
    if quantized:
        kq, ks = kvq.quantize_kv_write(k_new)
        vq, vs = kvq.quantize_kv_write(v_new)
        _kv_write(k_cache, kq, write_pos, active)
        _kv_write(v_cache, vq, write_pos, active)
        _kv_write(k_scale, ks, write_pos, active)
        _kv_write(v_scale, vs, write_pos, active)
        k_read, v_read = k_cache, v_cache    # sdpa folds scales; others
        if backend != "sdpa":                # take a dequantised view
            k_read = kvq.dequantize_kv(k_cache, k_scale, x.dtype)
            v_read = kvq.dequantize_kv(v_cache, v_scale, x.dtype)
    else:
        _kv_write(k_cache, k_new, write_pos, active)
        _kv_write(v_cache, v_new, write_pos, active)
        k_read, v_read = k_cache, v_cache
    out = _decode_attend(q, k_read, v_read, mask, cfg, backend, x.dtype,
                         k_scale=k_scale if quantized else None,
                         v_scale=v_scale if quantized else None)
    return matmul(out, p["wo"])


# --------------------------------------------------------------------------
# paged decode (slot -> block-table -> page-pool indirection)
# --------------------------------------------------------------------------

def paged_view(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Gather a slot-major contiguous view out of a page pool: pool
    (n_pages, page_size, ...) and block_table (B, max_blocks) ->
    (B, max_blocks * page_size, ...)."""
    B, max_blocks = block_table.shape
    pages = pool[block_table.long()]
    return pages.reshape(B, max_blocks * pool.shape[1], *pool.shape[2:])


def paged_write_rows(block_table: torch.Tensor, pos: torch.Tensor, page_size: int,
                     active: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each lane's new K/V row goes in a paged decode step, the
    same for every layer: (page, offset, writer), (B,) each.  The row is
    ``block_table[b, pos[b] // page_size]`` at ``pos[b] % page_size``;
    ``active`` (B,) bool redirects inactive lanes to the garbage page 0.
    Lanes that land on one row (inactive and free lanes, on page 0) all
    write the values of the last of them, lane ``writer[b]``: the row
    then holds what a serial write in lane order leaves (the CPU's
    scatter), whatever order the card's scatter takes.  Free lanes read
    page 0, and a MoE routes them beside live lanes, so that row reaches
    live tokens through the experts' capacity."""
    blk = (pos // page_size).clamp(max=block_table.shape[1] - 1)
    page = block_table.gather(1, blk[:, None].long())[:, 0]
    if active is not None:
        page = torch.where(active, page, 0)   # 0 = reserved garbage page
    page, off = page.long(), (pos % page_size).long()
    row = page * page_size + off
    lanes = torch.arange(row.shape[0], device=row.device)
    writer = torch.where(row[:, None] == row[None, :], lanes, -1).amax(dim=1)
    return page, off, writer


def attention_decode_paged(p: Params, x: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           pos: torch.Tensor, mask: torch.Tensor,
                           angles: torch.Tensor, cfg: ArchConfig,
                           apply_rope_fn, backend: str = "sdpa",
                           rows=None, k_scale_pool=None,
                           v_scale_pool=None) -> torch.Tensor:
    """One-token decode through a paged KV cache.

    x (B,1,D); k_pool/v_pool (n_pages, page_size, Hkv, hd); block_table
    (B, max_blocks); pos (B,) absolute per-slot positions.  The new K/V
    row is written in place into the slot's current page
    (``block_table[b, pos[b] // page_size]`` at offset
    ``pos[b] % page_size``); ``rows`` is ``paged_write_rows``' (page,
    offset, writer) for the step (computed here, all lanes active, when
    None), which redirects inactive lanes' writes to the garbage page 0.
    Lanes whose block-table row
    points at page 0 (free or mid-prefill slots) write there and read
    finite junk that the scheduler discards.  k_scale_pool/v_scale_pool
    (n_pages, page_size, Hkv) select the int8 pool: the row is quantised
    on write, codes and scales at the same page and offset.  ``mask`` is
    the (B, max_blocks*page_size) valid-slot mask the gather routes use;
    a slot's live length is pos+1.  Returns the attention output
    (B,1,D)."""
    from repro_torch.quant.paths import matmul
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope_fn(q, angles)
    k_new = apply_rope_fn(k_new, angles)
    page, off, writer = (rows if rows is not None else
                         paged_write_rows(block_table, pos, k_pool.shape[1]))
    quantized = k_scale_pool is not None
    if quantized:
        from repro_torch.quant import kv as kvq
        k_new, ks = kvq.quantize_kv_write(k_new)
        v_new, vs = kvq.quantize_kv_write(v_new)
        k_scale_pool[page, off] = ks[:, 0].index_select(0, writer)
        v_scale_pool[page, off] = vs[:, 0].index_select(0, writer)
    k_pool[page, off] = k_new[:, 0].index_select(0, writer).to(k_pool.dtype)
    v_pool[page, off] = v_new[:, 0].index_select(0, writer).to(v_pool.dtype)
    paged = (k_pool, v_pool, block_table, pos + 1)
    if quantized:
        paged = paged + (k_scale_pool, v_scale_pool)
    out = _decode_attend(q, None, None, mask, cfg, backend, x.dtype,
                         paged=paged)
    return matmul(out, p["wo"])


def attention_prefill_paged(p: Params, x: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, slot_pages: torch.Tensor,
                            start_pos: int, angles: torch.Tensor,
                            cfg: ArchConfig, apply_rope_fn,
                            k_scale_pool=None, v_scale_pool=None
                            ) -> torch.Tensor:
    """Prefill one chunk of ONE session through the paged cache.

    x (1, C, D) is the chunk's hidden states; ``slot_pages``
    (max_blocks,) is the session's block-table row; ``start_pos`` is the
    page-aligned absolute position of chunk token 0.  The chunk's K/V
    (int8 codes and scales with scale pools) are written in place into
    the slot's pages, then the chunk attends causally over the cached
    prefix plus itself through the gathered view — exact math, so
    chunked prefill is token-identical to whole-prompt prefill.  Returns
    the attention output (1, C, D)."""
    from repro_torch.quant import kv as kvq
    from repro_torch.quant.paths import matmul
    _, C, _ = x.shape
    page_size = k_pool.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope_fn(q, angles)
    k_new = apply_rope_fn(k_new, angles)
    n_chunk_pages = -(-C // page_size)
    pad = n_chunk_pages * page_size - C

    def to_pages(t, dtype):   # (1, C, ...) -> (n_pages_c, page, ...)
        t = torch.cat([t[0], t.new_zeros((pad,) + t.shape[2:])]) if pad else t[0]
        return t.reshape((n_chunk_pages, page_size) + t.shape[1:]).to(dtype)

    first = start_pos // page_size
    idx = slot_pages[first:first + n_chunk_pages].long()
    quantized = k_scale_pool is not None
    if quantized:
        k_new, ks = kvq.quantize_kv_write(k_new)
        v_new, vs = kvq.quantize_kv_write(v_new)
        k_scale_pool.index_copy_(0, idx, to_pages(ks, torch.float32))
        v_scale_pool.index_copy_(0, idx, to_pages(vs, torch.float32))
    k_pool.index_copy_(0, idx, to_pages(k_new, k_pool.dtype))
    v_pool.index_copy_(0, idx, to_pages(v_new, v_pool.dtype))
    table = slot_pages[None, :]
    if quantized:
        k_view = kvq.dequantize_kv(paged_view(k_pool, table),
                                   paged_view(k_scale_pool, table), x.dtype)
        v_view = kvq.dequantize_kv(paged_view(v_pool, table),
                                   paged_view(v_scale_pool, table), x.dtype)
    else:
        k_view = paged_view(k_pool, table)
        v_view = paged_view(v_pool, table)
    virtual = k_view.shape[1]
    qpos = start_pos + torch.arange(C, device=x.device)
    mask = torch.arange(virtual, device=x.device)[None, :] <= qpos[:, None]
    scores = _gqa_scores(q, k_view.to(q.dtype), cfg)        # (1,K,G,C,virt)
    scores = torch.where(mask[None, None, None], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v_view.to(q.dtype), cfg).to(x.dtype)
    return matmul(out, p["wo"])
