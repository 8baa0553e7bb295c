"""Wrapper for the RMSNorm kernel (``csrc/rmsnorm.cu``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``.  ``launches`` counts kernel
launches (one per call that reached the card; a call recorded into a
CUDA graph counts once, at capture).  The kernel launches on the current
stream and the wrapper allocates only the output, so a call can be
captured into a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ref

DTYPES = (torch.bfloat16, torch.float32)

launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [p, ctypes.c_longlong, p, p, i, i,
                                   ctypes.c_float, i, p]
    lib.rmsnorm_launch.restype = i
    return lib


def _check(x: torch.Tensor, w: Optional[torch.Tensor]) -> None:
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"want x (..., D) with D >= 1; got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be bf16 or f32; got {x.dtype}")
    if w is not None:
        if tuple(w.shape) != (x.shape[-1],) or w.dtype != x.dtype:
            raise ValueError(f"w must be ({x.shape[-1]},) {x.dtype}; got "
                             f"{tuple(w.shape)} {w.dtype}")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("w must be contiguous on x's device")


def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) bf16/f32, w (D,) in x's dtype or None.  Returns
    x * rsqrt(mean(x^2) + eps) * w in x's shape and dtype, computed in
    f32.  A strided x whose rows share one stride is read in place.  On
    the card D and the row stride must be multiples of 16 bytes."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm for device {x.device}")
    _check(x, w)
    D = x.shape[-1]
    x2 = x.reshape(-1, D)            # a view where the strides allow it
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    R = x2.shape[0]
    if R == 0:
        return out
    per16 = 16 // x.element_size()
    ptrs = [x2.data_ptr(), out.data_ptr()] + ([w.data_ptr()] if w is not None
                                              else [])
    if D % per16 or x2.stride(0) % per16 or any(ptr % 16 for ptr in ptrs):
        raise ValueError(f"kernel takes 16-byte aligned rows: D and the row "
                         f"stride multiples of {per16}, x and w 16-byte "
                         f"aligned; got D={D}, stride {x2.stride(0)}")
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_launch(
            x2.data_ptr(), x2.stride(0), None if w is None else w.data_ptr(),
            out.data_ptr(), R, D, eps, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    global launches
    launches += 1
    return out
