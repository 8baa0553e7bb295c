"""Wrapper for the fused int4 matmul kernel (``csrc/int4_matmul.cu``).

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
from repro_torch.kernels.int4_matmul import ref

GEMV_MAX_M = 4         # rows of x the split-K GEMV serves (kGemvMaxM)
GEMV_COLS = 256        # output columns per GEMV block (32 lanes x 8)
GEMV_ROWS = 16         # a K slice is a multiple of this (8 warps x 2 rows)

launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int4_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int4_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.int4_matmul_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(K: int, N: int, n_sm: int):
    """(splits, k_split) of the GEMV: K slices of k_split rows (a multiple
    of GEMV_ROWS), enough of them that about two blocks land on each
    SM."""
    col_blocks = math.ceil(N / GEMV_COLS)
    splits = max(1, min(math.ceil(K / GEMV_ROWS), round(2 * n_sm / col_blocks)))
    k_split = GEMV_ROWS * math.ceil(K / splits / GEMV_ROWS)
    return math.ceil(K / k_split), k_split


def _check(x, packed, scales, group):
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError("want x (M,K), packed (K//2,N), scales (K//group,N)")
    M, K = x.shape
    K2, N = packed.shape
    if K != 2 * K2 or group % 2 or K % group or \
            tuple(scales.shape) != (K // group, N):
        raise ValueError(f"shapes x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales {tuple(scales.shape)} "
                         f"do not fit group {group}")
    if M <= GEMV_MAX_M and N % 8:
        raise ValueError(f"the GEMV takes N % 8 == 0; got N={N}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"want x bf16/f32, packed uint8, scales f32; got "
                        f"{x.dtype}, {packed.dtype}, {scales.dtype}")
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                *, group: int = 128) -> torch.Tensor:
    """x (M, K) @ int4-packed (K//2, N) with per-group scales -> (M, N) in
    x's dtype, accumulated in f32."""
    if x.device.type == "cpu":
        return ref.int4_matmul_ref(x, packed, scales, group)
    if x.device.type != "cuda":
        raise ValueError(f"no int4_matmul for device {x.device}")
    _check(x, packed, scales, group)
    M, K = x.shape
    N = packed.shape[1]
    splits, k_split = 1, K
    if M <= GEMV_MAX_M:
        splits, k_split = split_plan(K, N, _sm_count(x.device.index))
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.int4_matmul_launch(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            part.data_ptr() if part is not None else None, out.data_ptr(),
            M, K, N, group, splits, k_split, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int4_matmul")
    global launches
    launches += 1
    return out
