"""Wrapper for the decode-attention kernel (``csrc/decode_attention.cu``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``.  ``launches`` counts kernel
launches (one per call that reached the card).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

TILE = 32          # tokens per tile inside a block (kTile in the source)
MAX_SPLIT = 1024   # most partials the merge kernel takes (kMaxSplit)
G_MAX = 16         # most query heads per KV head (kGMax)
HEAD_DIMS = (32, 64, 128)

launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [
        p, p, p, p, ctypes.c_longlong, p, p, p, p,
        i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.decode_attention_launch.restype = i
    return lib


def split_plan(S: int):
    """(n_split, chunk): one TILE of slots per block, so that every
    block's K/V loads are in flight at once, unless that would exceed
    MAX_SPLIT partials; chunk is a multiple of TILE."""
    chunk = TILE * math.ceil(math.ceil(S / TILE) / MAX_SPLIT)
    return math.ceil(S / chunk), chunk


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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd); k/v (B, S, Hkv, hd); mask (S,) shared or (B, S) per
    sequence, nonzero = valid slot.  Returns (B, Hq, hd) in q's dtype; a
    row with no valid slot is zeros."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    _check(q, k, v, mask)
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    n_split, chunk = split_plan(S)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, Hkv, n_split, G), **f32)
    l_part = torch.empty((B, Hkv, n_split, G), **f32)
    acc_part = torch.empty((B, Hkv, n_split, G, hd), **f32)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            S if mask.dim() == 2 else 0,
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            out.data_ptr(), B, S, Hkv, G, hd, n_split, chunk, hd ** -0.5,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attention")
    global launches
    launches += 1
    return out
