"""Wrapper for the decode-attention kernel (``csrc/decode_attention.cu``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``.  ``path_for`` names the kernel's
path for a call: "mma" for bf16 q (tensor cores, one launch whose last
block per (b, KV head) adds the splits' partials through a ticket it
resets), "cuda_core" for f32 q (a partial and a merge kernel).
``launches`` counts calls that reached the card (a call recorded into a
CUDA graph counts once, at capture).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.decode_attention import ref

TILE = 32          # tokens per tile of the CUDA-core path (kTile in the source)
MAX_SPLIT = 1024   # most partials its merge kernel takes (kMaxSplit)
MMA_UNIT = 16      # tokens per split unit of the mma path (kUnit)
MMA_TILE = 64      # tokens per ring tile of the mma path (kMmaTile)
MMA_MAX_SPLIT = 128  # most splits per (b, KV head) on the mma path
# blocks the split plan gives an SM (the kernel fits two): one 64-slot
# tile per block at qwen2.5-7b's shape (33 splits) beat 11-44 splits on
# the H100 (scripts/decode_attention_probe.py)
MMA_BLOCKS_PER_SM = 1
MAX_PAIRS = 4096   # most (b, KV head) pairs: the tickets (kMaxPairs)
G_MAX = 16         # most query heads per KV head (kGMax)
HEAD_DIMS = (32, 64, 128)

launches = 0
_tickets = {}      # device index -> int32 (MAX_PAIRS,), all 0 between calls


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [
        p, p, p, p, ll, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_mma_launch.argtypes = [
        p, p, p, p, ll, p, p, p, p, i, i, i, i, i, i, p]
    lib.decode_attention_mma_launch.restype = i
    lib.decode_attention_mma_blocks_per_sm.argtypes = [i]
    lib.decode_attention_mma_blocks_per_sm.restype = i
    return lib


def path_for(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel path a call with this q and cache takes: "mma" for bf16
    (tensor cores, one launch), "cuda_core" for f32 (partial + merge)."""
    return "mma" if q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16 \
        else "cuda_core"


def split_plan(S: int):
    """The CUDA-core path's (n_split, chunk): one TILE of slots per
    block, so that every block's K/V loads are in flight at once, unless
    that would exceed MAX_SPLIT partials; chunk is a multiple of TILE."""
    chunk = TILE * math.ceil(math.ceil(S / TILE) / MAX_SPLIT)
    return math.ceil(S / chunk), chunk


def mma_split_plan(B: int, Hkv: int, S: int, n_sm: int) -> int:
    """Splits per (b, KV head) on the mma path: as many as give each of
    n_sm SMs MMA_BLOCKS_PER_SM blocks, so every block is resident at
    once; at most MMA_MAX_SPLIT and one per 16-token unit of S.  From
    the shapes alone: the mask stays on the card, so the call captures."""
    waves = MMA_BLOCKS_PER_SM * n_sm // (B * Hkv)
    return max(1, min(waves, MMA_MAX_SPLIT, math.ceil(S / MMA_UNIT)))


def split_range(S: int, split: int, n_split: int):
    """Slots [s0, s1) of S that split ``split`` of ``n_split`` takes on
    the mma path, as the kernel cuts them (``split_range`` in the
    source): whole 16-token units, the runs differing by at most one
    unit, clipped to S."""
    units = -(-S // MMA_UNIT)
    s0 = units * split // n_split * MMA_UNIT
    s1 = min(units * (split + 1) // n_split * MMA_UNIT, S)
    return s0, s1


def _check(q, k, v, mask):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Hq,hd), k/v (B,S,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if hd not in HEAD_DIMS or Hq // Hkv > G_MAX:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} and G <= {G_MAX}; "
                         f"got hd={hd}, G={Hq // Hkv}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share bf16 or f32; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if mask.dtype not in (torch.bool, torch.int8, torch.uint8) or \
            tuple(mask.shape) not in ((S,), (B, S)):
        raise ValueError(f"mask must be bool/int8 (S,) or (B,S); got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _dt.check_pointers("decode_attention",
                       (("q", q), ("k", k), ("v", v), ("mask", mask)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd); k/v (B, S, Hkv, hd); mask (S,) shared or (B, S) per
    sequence, nonzero = valid slot.  Returns (B, Hq, hd) in q's dtype; a
    row with no valid slot is zeros.  A masked slot's K/V row is never
    read.  ``path_for`` names the kernel path.

    DTensors run on their local shards (``_dtensor.local_call``): batch
    and KV heads (with their query heads) may stay split; a split
    sequence or head_dim is all-gathered first, as is a cache sharded
    over the sequence."""
    if _dt.any_dtensor(q, k, v, mask):
        return _dt.local_call(decode_attention,
                              [(q, "bh."), (k, "b.h."), (v, "b.h."),
                               (mask, "b." if mask.dim() == 2 else ".")],
                              ["bh."])
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    _check(q, k, v, mask)
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bstride = S if mask.dim() == 2 else 0
    lib = _lib()
    if path_for(q, k) == "mma":
        if B * Hkv > MAX_PAIRS:
            raise ValueError(f"the mma path takes B * Hkv <= {MAX_PAIRS}")
        n_split = mma_split_plan(B, Hkv, S, _build.sm_count(q.device.index))
        acc = ml = tickets = None
        if n_split > 1:
            # one scratch tensor: the (m, l) partials in f32, then from a
            # 16-byte boundary the acc partials in bf16
            ml_bytes = -(-B * Hkv * n_split * 2 * G * 4 // 16) * 16
            part = torch.empty(ml_bytes + B * Hkv * n_split * G * hd * 2,
                               dtype=torch.uint8, device=q.device)
            ml, acc = part.data_ptr(), part.data_ptr() + ml_bytes
            tickets = _build.ticket_buffer(_tickets, q.device, MAX_PAIRS,
                                            "decode_attention").data_ptr()
        with torch.cuda.device(q.device):
            rc = lib.decode_attention_mma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                bstride, acc, ml, tickets, out.data_ptr(), B, S, Hkv, G, hd,
                n_split, stream)
    else:
        n_split, chunk = split_plan(S)
        f32 = dict(dtype=torch.float32, device=q.device)
        m_part = torch.empty((B, Hkv, n_split, G), **f32)
        l_part = torch.empty((B, Hkv, n_split, G), **f32)
        acc_part = torch.empty((B, Hkv, n_split, G, hd), **f32)
        with torch.cuda.device(q.device):
            rc = lib.decode_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                bstride, m_part.data_ptr(), l_part.data_ptr(),
                acc_part.data_ptr(), out.data_ptr(), B, S, Hkv, G, hd,
                n_split, chunk, hd ** -0.5, stream)
    _build.check(rc, "decode_attention")
    global launches
    launches += 1
    return out
