"""Wrappers for the RMSNorm kernels (``csrc/rmsnorm.cu``): the forward
and its gradient.

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``.  ``launches`` counts forward
launches and ``bwd_launches`` backward ones (one per call that reached
the card; a call recorded into a CUDA graph counts once, at capture).
The kernels launch on the current stream and the wrappers allocate only
the outputs and the backward's scratch, so a call can be captured into a
CUDA graph.  How the forward spreads rows over warps, blocks and the
grid is ``norm_plan``'s, the backward's ``bwd_plan``'s, from the shapes
and the SM count.

``rmsnorm`` is differentiable: under grad mode, when x or w requires
grad, it runs through ``RMSNormFunction`` (the forward kernel, and the
backward kernel for the gradient); otherwise (``inference_mode``,
``no_grad``, or no input that requires grad) it launches the forward
kernel directly.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.rmsnorm import ref

DTYPES = (torch.bfloat16, torch.float32)
MAX_CHUNKS = 8        # 16-byte chunks of a row one lane holds (kMaxChunks)
PROMPT_CHUNKS = 5     # the most a lane holds on prompt rows
PROMPT_THREADS = 256  # threads of a block of prompt rows
BLOCKS_PER_SM = 2     # prompt blocks the grid puts on each SM

BWD_MAX_CHUNKS = 4    # 16-byte chunks of a row a backward lane holds
BWD_MAX_WARPS = 16    # warps of a backward row (kBwdMaxWarps)
BWD_BLOCKS_PER_SM = 2  # backward blocks the grid puts on each SM

launches = 0
bwd_launches = 0


class NormPlan(NamedTuple):
    warps_per_row: int    # warps that own one row
    rows_per_block: int   # rows a block holds at once, one per warp group
    chunks: int           # 16-byte chunks of its row each lane holds
    grid: int             # blocks; block b's group g takes rows
    #                       b * rows_per_block + g + k * grid * rows_per_block


def max_threads(chunks: int) -> int:
    """Threads a block may have at ``chunks`` chunks a lane (the kernel's
    ``max_threads``: each lane holds three times that many registers)."""
    return 1024 if chunks <= 2 else 512 if chunks <= 4 else 256


@functools.lru_cache(maxsize=1024)
def norm_plan(R: int, D: int, itemsize: int, n_sm: int,
              warps_per_row: Optional[int] = None,
              blocks_per_sm: int = BLOCKS_PER_SM) -> NormPlan:
    """How the kernel covers R rows of D elements of ``itemsize`` bytes on
    n_sm SMs.  Fewer rows than SMs (decode rows): one block a row, with
    enough warps that every 16-byte chunk has a lane (one chunk a lane up
    to 1024 chunks, two up to 2048: D 16384 bf16, 8192 f32).  Otherwise
    (a prompt's rows): warps per row such that a lane holds at most
    PROMPT_CHUNKS where the block allows it, blocks of at most PROMPT_THREADS
    threads, at most ``blocks_per_sm`` blocks an SM; a block walks its
    rows in a loop.  ``warps_per_row`` overrides the choice (the probe's
    sweep); a plan the kernel cannot run raises ValueError."""
    nvec = D * itemsize // 16
    decode = R < n_sm

    def fits(w):
        c = math.ceil(nvec / (32 * w))
        return c <= MAX_CHUNKS and 32 * w <= max_threads(c)
    if warps_per_row is None:
        # the widest spread of a row the block allows
        wide = next((w for w in (math.ceil(nvec / (32 * c)) for c in range(1, MAX_CHUNKS + 1))
                     if fits(w)), 32)
        narrow = math.ceil(nvec / (32 * PROMPT_CHUNKS))
        warps_per_row = narrow if not decode and fits(narrow) else wide
    chunks = math.ceil(nvec / (32 * warps_per_row))
    if not fits(warps_per_row):
        raise ValueError(f"rows of {nvec} 16-byte chunks do not fit {warps_per_row} "
                         f"warps of at most {MAX_CHUNKS} chunks a lane")
    if decode:
        return NormPlan(warps_per_row, 1, chunks, R)
    per_block = max(1, PROMPT_THREADS // (32 * warps_per_row))
    if warps_per_row > 1:
        per_block = min(per_block, 15)     # one named barrier per group
    return NormPlan(warps_per_row, per_block, chunks,
                    min(math.ceil(R / per_block), n_sm * blocks_per_sm))


def rows_of(plan: NormPlan, R: int, block: int, group: int) -> range:
    """The rows group ``group`` of block ``block`` normalises, as the
    kernel walks them."""
    step = plan.grid * plan.rows_per_block
    return range(block * plan.rows_per_block + group, R, step)


def chunks_of(plan: NormPlan, nvec: int, lane: int) -> list:
    """The 16-byte chunks of a row that lane ``lane`` of its group holds."""
    span = 32 * plan.warps_per_row
    return [lane + j * span for j in range(plan.chunks) if lane + j * span < nvec]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [p, ctypes.c_longlong, p, p, i, i,
                                   ctypes.c_float, i, i, i, i, i, p]
    lib.rmsnorm_launch.restype = i
    lib.rmsnorm_bwd_launch.argtypes = [p, p, p, p, p, p, i, i, ctypes.c_float,
                                       i, i, i, i, p]
    lib.rmsnorm_bwd_launch.restype = i
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
    _dt.check_pointers("rmsnorm", (("x", x), ("w", w)))


def _rows(x) -> str:
    """The letters of x's dims for ``_dtensor.local_call``: each row dim
    its own axis, the normalised dim reduced."""
    return "abcdefghijklmnop"[:x.dim() - 1] + "."


def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) bf16/f32, w (D,) in x's dtype or None.  Returns
    x * rsqrt(mean(x^2) + eps) * w in x's shape and dtype, computed in
    f32.  A strided x whose rows share one stride is read in place.  On
    the card D and the row stride must be multiples of 16 bytes and a row
    at most 32 KB (D 16384 bf16, 8192 f32).  Differentiable in x and w
    (``RMSNormFunction``) under grad mode.  DTensors run on their local
    rows (``_dtensor.local_call``): D is gathered where it is sharded,
    and the rows stay as they are split."""
    if _dt.any_dtensor(x, w):
        return _dt.local_call(lambda xl, wl: rmsnorm(xl, wl, eps),
                              [(x, _rows(x)), (w, ".")], [_rows(x)])
    if torch.is_grad_enabled() and (x.requires_grad or (
            w is not None and w.requires_grad)):
        return RMSNormFunction.apply(x, w, eps)
    return _forward(x, w, eps)


def _forward(x: torch.Tensor, w: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    """The forward on x's device: the kernel on the card, the plain
    version on the CPU; DTensors on their local rows."""
    if _dt.any_dtensor(x, w):
        return _dt.local_call(lambda xl, wl: _forward(xl, wl, eps),
                              [(x, _rows(x)), (w, ".")], [_rows(x)])
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    if x.device.type == "meta":
        # the dry run's shapes: no data, nothing computed
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
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
    plan = norm_plan(R, D, x.element_size(), _build.sm_count(x.device.index))
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_launch(
            x2.data_ptr(), x2.stride(0), None if w is None else w.data_ptr(),
            out.data_ptr(), R, D, eps, int(x.dtype == torch.bfloat16), *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    global launches
    launches += 1
    return out


@functools.lru_cache(maxsize=1024)
def bwd_plan(R: int, D: int, itemsize: int, n_sm: int) -> Tuple[int, int, int]:
    """(warps, chunks, grid) of the backward kernel for R rows of D
    elements of ``itemsize`` bytes on n_sm SMs: a block of ``warps``
    warps owns one row at a time, each lane holding at most 2 of its
    16-byte chunks where 16 warps allow it (at most BWD_MAX_CHUNKS), and
    the grid has at most BWD_BLOCKS_PER_SM blocks an SM, each walking
    rows ``grid`` apart.  Raises ValueError for a row of more than 2048
    chunks (D 16384 bf16, 8192 f32)."""
    nvec = D * itemsize // 16
    warps = min(BWD_MAX_WARPS, max(1, math.ceil(nvec / 64)))
    chunks = math.ceil(nvec / (32 * warps))
    if chunks > BWD_MAX_CHUNKS:
        raise ValueError(f"rows of {nvec} 16-byte chunks do not fit "
                         f"{BWD_MAX_WARPS} warps of at most {BWD_MAX_CHUNKS} "
                         "chunks a lane")
    return warps, chunks, min(R, n_sm * BWD_BLOCKS_PER_SM)


def rmsnorm_bwd(x: torch.Tensor, w: Optional[torch.Tensor], dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``rmsnorm`` at x (..., D), w (D,) or None, for the
    output's gradient dy (x's shape): (dx in x's shape and dtype, dw in
    w's dtype or None), computed in f32 (``ref.rmsnorm_bwd_ref``'s
    formulas).  On the card: the backward kernel, then (with w) the
    fixed-order sum of its blocks' parts of dw; no atomics, so repeated
    calls give the same bits.  x and dy are read contiguous (copied
    first when they are not).  DTensors run on their local rows; dw of
    rows split over a mesh dim is the sum of the ranks' parts, returned
    ``Partial()`` there."""
    if _dt.any_dtensor(x, w, dy):
        return _dt.local_call(lambda xl, wl, dyl: rmsnorm_bwd(xl, wl, dyl, eps),
                              [(x, _rows(x)), (w, "."), (dy, _rows(x))],
                              [_rows(x), "."], sums=(False, True))
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, w, dy, eps)
    if x.device.type == "meta":
        # the dry run's shapes: no data, nothing computed
        return (torch.empty(x.shape, dtype=x.dtype, device="meta"),
                None if w is None else torch.empty_like(w))
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm_bwd for device {x.device}")
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on x's device; "
                         f"got {tuple(dy.shape)} {dy.dtype} {dy.device}")
    _dt.check_pointers("rmsnorm_bwd", (("dy", dy),))
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    dy2 = dy.reshape(-1, D).contiguous()
    R = x2.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = None if w is None else torch.empty_like(w)
    if R == 0:
        if dw is not None:
            dw.zero_()
        return dx, dw
    per16 = 16 // x.element_size()
    if D % per16 or any(t.data_ptr() % 16 for t in (x2, dy2)):
        raise ValueError(f"kernel takes 16-byte aligned rows: D a multiple of "
                         f"{per16}, x and dy 16-byte aligned; got D={D}")
    warps, chunks, grid = bwd_plan(R, D, x.element_size(),
                                   _build.sm_count(x.device.index))
    part = (None if w is None else
            torch.empty((grid, D), dtype=torch.float32, device=x.device))
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_bwd_launch(
            x2.data_ptr(), dy2.data_ptr(), None if w is None else w.data_ptr(),
            dx.data_ptr(), None if dw is None else dw.data_ptr(),
            None if part is None else part.data_ptr(), R, D, eps,
            int(x.dtype == torch.bfloat16), warps, chunks, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` with its gradient: forward ``_forward`` (the kernel on
    the card, ``ref.rmsnorm_ref`` on the CPU), backward ``rmsnorm_bwd``
    (the backward kernel on the card, ``ref.rmsnorm_bwd_ref`` on the
    CPU).  Saves x and w; r is recomputed from x in the backward.  On
    DTensors both run on the local rows, and dw comes back ``Partial()``
    on the mesh dims that split the rows (``rmsnorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _forward(x, w, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None
