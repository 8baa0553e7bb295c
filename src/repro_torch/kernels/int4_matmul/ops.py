"""Wrapper for the fused int4 matmul kernel (``csrc/int4_matmul.cu``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``.  ``path_for`` names the kernel's
path for a call: the split-K GEMV for M <= 4 (one launch: the last block
of each column tile adds the K slices), the wgmma tensor-core GEMM for
bf16 x with M > 4, the f32 tiled loop otherwise.  ``launches`` counts
kernel launches (one per call that reached the card).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.int4_matmul import ref

GEMV_MAX_M = 4         # rows of x the GEMV serves (kGemvMaxM)
GEMV_TILE = 128        # output columns per GEMV block (8 lanes x 16)
GEMV_N = 16            # the GEMV takes N a multiple of this (16-byte loads)
GEMV_GROUP = 16        # ... and the scale group a multiple of this (k16 steps)
GEMV_BLOCKS_PER_SM = 2   # GEMV blocks an SM holds at once (__launch_bounds__)
GEMV_SMEM = 96 << 10   # most shared memory a block's x and scale rows may take
GEMV_TICKETS = 4096    # column tiles the per-device ticket buffer serves
WGMMA_GROUP = 16       # the wgmma path's scale group is a multiple of this
WGMMA_N = 4            # ... and N a multiple of this (4-byte copies)

launches = 0
_tickets = {}          # device index -> int32 (GEMV_TICKETS,), all 0 between calls


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int4_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int4_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.int4_matmul_launch.restype = i
    return lib


def split_plan(K: int, N: int, n_sm: int, M: int = 1, group: int = 128) -> int:
    """K slices of the GEMV, each a run of whole scale groups (the slices
    differ by at most one group): as many as let every block of the grid
    be resident at once (GEMV_BLOCKS_PER_SM on each of n_sm SMs), since
    each block streams its slice with loads in flight throughout; at
    least enough that a block's x and scale rows fit GEMV_SMEM."""
    G, tiles = K // group, math.ceil(N / GEMV_TILE)
    splits = max(1, GEMV_BLOCKS_PER_SM * n_sm // tiles)
    # per group: x as bf16 pairs and f32 remainders, one 128-column scale row
    fit = math.ceil(G * (group // 2 * M * 8 + GEMV_TILE * 4) / GEMV_SMEM)
    return min(G, max(splits, fit))


def path_for(M: int, dtype: torch.dtype) -> str:
    """The kernel path a call with M rows of x in ``dtype`` takes:
    "gemv", "wgmma" or "tiled"."""
    if M <= GEMV_MAX_M:
        return "gemv"
    return "wgmma" if dtype == torch.bfloat16 else "tiled"


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
    path = path_for(M, x.dtype)
    if path == "gemv" and (N % GEMV_N or group % GEMV_GROUP):
        raise ValueError(f"the GEMV takes N % {GEMV_N} == 0 and group % "
                         f"{GEMV_GROUP} == 0; got N={N}, group={group}")
    if path == "wgmma" and (group % WGMMA_GROUP or N % WGMMA_N):
        raise ValueError(f"the wgmma path takes group % {WGMMA_GROUP} == 0 "
                         f"and N % {WGMMA_N} == 0; got group={group}, N={N}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"want x bf16/f32, packed uint8, scales f32; got "
                        f"{x.dtype}, {packed.dtype}, {scales.dtype}")
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _dt.check_pointers("int4_matmul",
                       (("x", x), ("packed", packed), ("scales", scales)))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                *, group: int = 128) -> torch.Tensor:
    """x (M, K) @ int4-packed (K//2, N) with per-group scales -> (M, N) in
    x's dtype, accumulated in f32.  DTensors run on their local shards
    (``_dtensor.local_call``): rows and columns may stay split, a split
    K is all-gathered first."""
    if _dt.any_dtensor(x, packed, scales):
        return _dt.local_call(int4_matmul,
                              [(x, "m."), (packed, ".n"), (scales, ".n")],
                              ["mn"], kwargs={"group": group})
    if x.device.type == "cpu":
        return ref.int4_matmul_ref(x, packed, scales, group)
    if x.device.type != "cuda":
        raise ValueError(f"no int4_matmul for device {x.device}")
    _check(x, packed, scales, group)
    M, K = x.shape
    N = packed.shape[1]
    splits, part, tickets = 1, None, None
    if M <= GEMV_MAX_M:
        if math.ceil(N / GEMV_TILE) > GEMV_TICKETS:
            raise ValueError(f"the GEMV takes N <= {GEMV_TICKETS * GEMV_TILE}")
        splits = split_plan(K, N, _build.sm_count(x.device.index), M, group)
        if splits > 1:
            part = torch.empty((splits, M, N), dtype=torch.float32,
                               device=x.device)
            tickets = _build.ticket_buffer(_tickets, x.device, GEMV_TICKETS,
                                           "int4_matmul")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.int4_matmul_launch(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            part.data_ptr() if part is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            out.data_ptr(), M, K, N, group, splits,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int4_matmul")
    global launches
    launches += 1
    return out
