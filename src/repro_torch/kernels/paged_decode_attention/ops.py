"""Wrapper for the paged decode-attention kernel
(``csrc/paged_decode_attention.cu``) and the analytic per-step KV
traffic accounting of the two paged routes.

Port of ``repro.kernels.paged_decode_attention.ops``.  A CUDA tensor
launches the kernel, or the wrapper raises; a CPU tensor takes the plain
version in ``ref.py``.  ``path_for`` names the kernel's path for a call:
"mma" for bf16 q (bf16 or int8 pools; tensor cores, one launch whose
last block per (slot, KV head) adds the splits' partials through a
ticket it resets), "cuda_core" for f32 q (f32 or int8 pools; a partial
and a merge kernel).  ``launches`` counts calls that reached the card (a
call recorded into a CUDA graph counts once, at capture).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.paged_decode_attention import ref

TILE = 32          # tokens per tile of the CUDA-core path (kTile)
MAX_SPLIT = 1024   # most partials its merge kernel takes (kMaxSplit)
MMA_UNIT = 16      # tokens per split unit of the mma path (kUnit)
MMA_MAX_SPLIT = 128  # most splits per (slot, KV head) on the mma path
# blocks the split plan gives an SM (the kernel fits two): bf16 pools are
# bound by DRAM and gain from a smaller merge; int8 pools, by widening
# the codes, from more warps (measured at the serving shape)
MMA_BLOCKS_PER_SM = {False: 1, True: 2}   # by int8 KV
MAX_PAIRS = 4096   # most (slot, KV head) pairs: the tickets (kMaxPairs)
G_MAX = 16         # most query heads per KV head (kGMax)
HEAD_DIMS = (32, 64, 128)
PAGE_SIZES = (4, 8, 16, 32)

launches = 0
_tickets = {}      # device index -> int32 (MAX_PAIRS,), all 0 between calls


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_attention_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p,
        i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.paged_decode_attention_launch.restype = i
    lib.paged_decode_attention_mma_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.paged_decode_attention_mma_launch.restype = i
    lib.paged_decode_attention_mma_blocks_per_sm.argtypes = [i, i]
    lib.paged_decode_attention_mma_blocks_per_sm.restype = i
    return lib


def path_for(q: torch.Tensor, k_pool: torch.Tensor) -> str:
    """The kernel path a call with this q and these pools takes: "mma"
    for bf16 q over bf16 or int8 pools, "cuda_core" for f32 q over f32
    or int8 pools."""
    mma = q.dtype == torch.bfloat16 and k_pool.dtype in (torch.bfloat16,
                                                         torch.int8)
    return "mma" if mma else "cuda_core"


def split_plan(S: int):
    """The CUDA-core path's (n_split, chunk) over a virtual span of S
    tokens: one TILE per block unless that would exceed MAX_SPLIT
    partials."""
    chunk = TILE * math.ceil(math.ceil(S / TILE) / MAX_SPLIT)
    return math.ceil(S / chunk), chunk


def mma_split_plan(B: int, Hkv: int, S: int, n_sm: int, quant: bool = False) -> int:
    """Splits per (slot, KV head) on the mma path: as many as give each of
    n_sm SMs MMA_BLOCKS_PER_SM[quant] blocks, so every block is resident
    at once; at most MMA_MAX_SPLIT and one per 16-token unit of the
    virtual span S.  From the shapes alone: lengths stay on the card, so
    the call captures."""
    waves = MMA_BLOCKS_PER_SM[quant] * n_sm // (B * Hkv)
    return max(1, min(waves, MMA_MAX_SPLIT, math.ceil(S / MMA_UNIT)))


def split_range(length: int, split: int, n_split: int):
    """Tokens [s0, s1) of a slot with ``length`` live tokens that split
    ``split`` of ``n_split`` takes on the mma path, as the kernel cuts
    them (``split_range`` in the source): whole 16-token units, the runs
    differing by at most one unit, clipped to the length."""
    units = -(-length // MMA_UNIT)
    s0 = units * split // n_split * MMA_UNIT
    s1 = min(units * (split + 1) // n_split * MMA_UNIT, length)
    return s0, s1


def _check(q, k_pool, v_pool, block_table, lengths, ks, vs):
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"want q (B,Hq,hd), pools (n_pages,page,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, Hq, hd = q.shape
    _, page, Hkv, _ = k_pool.shape
    if k_pool.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)}")
    if hd not in HEAD_DIMS or Hq // Hkv > G_MAX or page not in PAGE_SIZES:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, G <= {G_MAX} and "
                         f"page in {PAGE_SIZES}; got hd={hd}, G={Hq // Hkv}, "
                         f"page={page}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32; got {q.dtype}")
    if ks is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise TypeError(f"pools must share q's dtype {q.dtype}; got "
                            f"{k_pool.dtype}, {v_pool.dtype}")
    else:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("with scale pools the pools hold int8 codes")
        for t in (ks, vs):
            if t.dtype != torch.float32 or t.shape != k_pool.shape[:3]:
                raise ValueError(f"scale pools must be f32 {tuple(k_pool.shape[:3])}; "
                                 f"got {t.dtype} {tuple(t.shape)}")
    if block_table.dtype != torch.int32 or block_table.dim() != 2 or \
            block_table.shape[0] != B:
        raise ValueError(f"block_table must be int32 (B, max_blocks); got "
                         f"{block_table.dtype} {tuple(block_table.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be int32 (B,); got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_table", block_table), ("lengths", lengths)]
    if ks is not None:
        named += [("k_scale_pool", ks), ("v_scale_pool", vs)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _dt.check_pointers("paged_decode_attention", named)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale_pool: Optional[torch.Tensor] = None,
                           v_scale_pool: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, Hq, hd); k_pool/v_pool (n_pages, page, Hkv, hd);
    block_table (B, max_blocks) int32; lengths (B,) int32 -> (B, Hq, hd)
    in q's dtype.

    Reads each slot's pages in place through the block table.  With
    scale pools (n_pages, page, Hkv) f32 the pools hold int8 codes, K
    and V are ``codes * scale``, and no dequantised copy is written.  A
    slot with ``lengths[b] == 0`` gives zeros.  ``path_for`` names the
    kernel path.

    DTensors run on their local shards (``_dtensor.local_call``): slots
    and KV heads (with their query heads) may stay split; pages, page
    rows and head_dim are all-gathered first (a block table names pages
    of the whole pool)."""
    quant = k_scale_pool is not None
    if _dt.any_dtensor(q, k_pool, v_pool, block_table, lengths,
                       k_scale_pool, v_scale_pool):
        return _dt.local_call(paged_decode_attention,
                              [(q, "bh."), (k_pool, "..h."), (v_pool, "..h."),
                               (block_table, "b."), (lengths, "b"),
                               (k_scale_pool, "..h"), (v_scale_pool, "..h")],
                              ["bh."])
    if q.device.type == "cpu":
        if quant:
            out = ref.paged_decode_attention_quant_ref(
                q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_table,
                lengths)
        else:
            out = ref.paged_decode_attention_ref(q, k_pool, v_pool,
                                                 block_table, lengths)
        return out.to(q.dtype)
    if q.device.type == "meta":
        # the dry run's shapes: no data, nothing computed
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_decode_attention for device {q.device}")
    _check(q, k_pool, v_pool, block_table, lengths, k_scale_pool, v_scale_pool)
    B, Hq, hd = q.shape
    _, page, Hkv, _ = k_pool.shape
    max_blocks = block_table.shape[1]
    G = Hq // Hkv
    out = torch.empty_like(q)
    ks = k_scale_pool.data_ptr() if quant else None
    vs = v_scale_pool.data_ptr() if quant else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    f32 = dict(dtype=torch.float32, device=q.device)
    lib = _lib()
    if path_for(q, k_pool) == "mma":
        if B * Hkv > MAX_PAIRS:
            raise ValueError(f"the mma path takes B * Hkv <= {MAX_PAIRS}")
        n_split = mma_split_plan(B, Hkv, max_blocks * page,
                                 _build.sm_count(q.device.index), quant)
        part_acc = part_ml = tickets = None
        if n_split > 1:
            part_acc = torch.empty((B, Hkv, n_split, G, hd), **f32)
            part_ml = torch.empty((B, Hkv, n_split, 2, G), **f32)
            tickets = _build.ticket_buffer(_tickets, q.device, MAX_PAIRS,
                                           "paged_decode_attention")
        with torch.cuda.device(q.device):
            rc = lib.paged_decode_attention_mma_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
                block_table.data_ptr(), lengths.data_ptr(),
                part_acc.data_ptr() if part_acc is not None else None,
                part_ml.data_ptr() if part_ml is not None else None,
                tickets.data_ptr() if tickets is not None else None,
                out.data_ptr(), B, max_blocks, page, Hkv, G, hd, n_split,
                int(quant), stream)
    else:
        n_split, chunk = split_plan(max_blocks * page)
        m_part = torch.empty((B, Hkv, n_split, G), **f32)
        l_part = torch.empty((B, Hkv, n_split, G), **f32)
        acc_part = torch.empty((B, Hkv, n_split, G, hd), **f32)
        with torch.cuda.device(q.device):
            rc = lib.paged_decode_attention_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
                block_table.data_ptr(), lengths.data_ptr(), m_part.data_ptr(),
                l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(), B,
                max_blocks, page, Hkv, G, hd, n_split, chunk, hd ** -0.5,
                int(quant), stream)
    _build.check(rc, "paged_decode_attention")
    global launches
    launches += 1
    return out


def kv_token_bytes(Hkv: int, hd: int, kv_bytes: int,
                   kv_quant: str = "none") -> int:
    """Stored bytes per cached token (K + V together).

    ``kv_quant="int8"``: one int8 code per element plus one float32
    scale per (token, head) for each of K and V."""
    if kv_quant == "int8":
        return 2 * Hkv * (hd + 4)
    return 2 * Hkv * hd * kv_bytes


def traffic_bytes(live_blocks: int, page_size: int, Hkv: int, hd: int,
                  *, n_slots: int, max_blocks: int, n_layers: int = 1,
                  kv_bytes: int = 2, kv_quant: str = "none") -> dict:
    """Analytic per-decode-step HBM KV traffic for the two paged routes.

    ``live_blocks`` is the summed ``ceil(live_len/page)`` over slots at
    that step (what the fused kernel walks).  The gather route is
    charged per layer for the full virtual view three times: the
    gather's pool read, the materialised-view write, and the attention's
    read of that view.  With ``kv_quant="int8"`` the fused kernel reads
    live pages once at stored width (codes + scales), while the gather
    route reads the pool at stored width and then writes and re-reads a
    dequantised model-dtype view of the whole virtual span.  ``floor``
    is the irreducible per-step KV term: live tokens once at stored
    width."""
    stored = kv_token_bytes(Hkv, hd, kv_bytes, kv_quant)
    model_tok = 2 * Hkv * hd * kv_bytes
    virtual = n_slots * max_blocks * page_size
    live = live_blocks * page_size
    if kv_quant == "none":
        gather = n_layers * 3 * virtual * model_tok
    else:
        gather = n_layers * virtual * (stored + 2 * model_tok)
    return {
        "fused": n_layers * live * stored,
        "gather_sdpa": gather,
        "floor": n_layers * live * stored,
    }


def serving_traffic_bytes(step_kv_blocks: Sequence[int], cfg, *,
                          page_size: int, n_slots: int, max_blocks: int,
                          kv_bytes: Optional[int] = None,
                          kv_quant: str = "none") -> dict:
    """Mean per-decode-step KV traffic for both routes from a run's
    live-block trace (``ContinuousResult.step_kv_blocks``).  ``kv_bytes``
    defaults to the element size of the model dtype."""
    if kv_bytes is None:
        kv_bytes = 4 if cfg.dtype == "float32" else 2
    mean_blocks = int(round(float(np.mean(np.asarray(step_kv_blocks)))))
    return traffic_bytes(mean_blocks, page_size, cfg.n_kv_heads,
                         cfg.head_dim, n_slots=n_slots,
                         max_blocks=max_blocks, n_layers=cfg.n_layers,
                         kv_bytes=kv_bytes, kv_quant=kv_quant)
