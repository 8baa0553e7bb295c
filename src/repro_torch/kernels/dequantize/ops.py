"""Wrapper for the weight dequantisation kernel (``csrc/dequantize.cu``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``; a meta tensor (the dry run's)
gets an empty meta tensor of the output's shape and dtype.  DTensors run
on their local shards (``_dtensor.local_call``).  ``launches`` counts
kernel launches (one per call that reached the card; a call recorded
into a CUDA graph counts once, at capture).  The kernel launches on the
current stream and the wrapper allocates only the output, so a call can
be captured into a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.dequantize import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CODE_DTYPES = {4: torch.uint8, 8: torch.int8}

launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dequantize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dequantize_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, i, p]
    lib.dequantize_launch.restype = i
    return lib


def out_shape(codes: torch.Tensor, bits: int) -> Tuple[int, ...]:
    """(..., K, N) of codes (..., K//2, N) int4 or (..., K, N) int8."""
    rows = codes.shape[-2] * (2 if bits == 4 else 1)
    return tuple(codes.shape[:-2]) + (rows, codes.shape[-1])


def _check(codes, scales, bits, dtype) -> int:
    """Refuse what the kernel does not take; returns the group."""
    if bits not in CODE_DTYPES:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if codes.dtype != CODE_DTYPES[bits]:
        raise TypeError(f"int{bits} codes must be {CODE_DTYPES[bits]}; got {codes.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be f32; got {scales.dtype}")
    if dtype not in DTYPES:
        raise TypeError(f"the output must be bf16, f16 or f32; got {dtype}")
    K = out_shape(codes, bits)[-2] if codes.dim() >= 2 else 0
    if codes.dim() < 2 or scales.dim() != codes.dim() \
            or scales.shape[:-2] != codes.shape[:-2] \
            or scales.shape[-1] != codes.shape[-1] \
            or scales.shape[-2] < 1 or K % scales.shape[-2]:
        raise ValueError(f"want codes (..., K{'//2' if bits == 4 else ''}, N) and "
                         f"scales (..., K//group, N); got {tuple(codes.shape)} and "
                         f"{tuple(scales.shape)}")
    group = K // scales.shape[-2]
    if bits == 4 and group % 2:
        raise ValueError(f"int4 groups must hold whole code rows; got group {group}")
    if scales.device != codes.device or not (codes.is_contiguous()
                                             and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous on one device")
    _dt.check_pointers("dequantize", (("codes", codes), ("scales", scales)))
    return group


def _lead(codes) -> str:
    """The letters of codes', scales' and the output's dims for
    ``_dtensor.local_call``: each leading dim its own axis, then K and N
    (a K split whose shards do not hold whole groups is gathered)."""
    return "abcdefghij"[:codes.dim() - 2] + "kn"


def dequantize(codes: torch.Tensor, scales: torch.Tensor, bits: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """codes (..., K//2, N) uint8 (int4, two rows a byte) or (..., K, N)
    int8, scales f32 (..., K//group, N) -> codes * repeat(scales) in
    ``dtype`` (bf16, f16 or f32), (..., K, N), each element rounded once.
    One launch covers every leading dim."""
    if _dt.any_dtensor(codes, scales):
        letters = _lead(codes)
        return _dt.local_call(lambda c, s: dequantize(c, s, bits, dtype),
                              [(codes, letters), (scales, letters)], [letters])
    if codes.device.type == "cpu":
        return ref.dequantize_ref(codes, scales, bits, dtype)
    if codes.device.type == "meta":
        # the dry run's shapes: no data, nothing computed
        return torch.empty(out_shape(codes, bits), dtype=dtype, device="meta")
    if codes.device.type != "cuda":
        raise ValueError(f"no dequantize for device {codes.device}")
    group = _check(codes, scales, bits, dtype)
    out = torch.empty(out_shape(codes, bits), dtype=dtype, device=codes.device)
    if out.numel() == 0:
        return out
    N = codes.shape[-1]
    code_rows = codes.numel() // N
    # vector accesses: a thread owns the columns of one 16-byte vector of output
    cols = 16 // out.element_size()
    vec = N % cols == 0 and all(t.data_ptr() % 16 == 0 for t in (codes, scales, out))
    with torch.cuda.device(codes.device):
        rc = _lib().dequantize_launch(
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(), code_rows, N, bits,
            group, DTYPES[dtype], int(vec),
            torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check(rc, "dequantize")
    global launches
    launches += 1
    return out
