"""Wrapper for the SSD decode-step kernel (``csrc/ssd_update.cu``).

Port of ``repro.kernels.ssd_update.ops``, with the reference wrapper's
signature.  A CUDA tensor launches the kernel, or the wrapper raises; a
CPU tensor takes the plain version in ``ref.py``.  ``launches`` counts
kernel launches (one per call that reached the card).  ``out=`` names
the tensor that receives h' and may be ``h`` itself: the decode step
updates its cache's state in place.  How the kernel spreads the rows of
the state over threads, blocks and the grid is ``ssd_plan``'s, from the
shapes and the SM count.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _dtensor as _dt
from repro_torch.kernels.ssd_update import ref

MIN_N = 16         # four lanes of 16-byte chunks per row at least
MAX_N = 256        # 32 lanes of two 16-byte chunks a row (kMaxN)
DTYPES = (torch.bfloat16, torch.float32)
WARPS = 8          # warps of a block
MIN_BLOCKS_PER_SM = 2   # the rows a thread takes shrink until the grid has these

launches = 0


def traffic_bytes(B: int, H: int, P: int, N: int) -> dict:
    """Analytic per-step HBM traffic: the SSM 'K' term of the floor (f32
    state read and written once; an unfused update sweeps it twice more)."""
    state = B * H * P * N * 4
    return {"state_read": state, "state_write": state,
            "unfused_extra_sweeps": 2 * state}


class SsdPlan(NamedTuple):
    lanes: int             # lanes of one row (4, 8, 16 or 32)
    chunks: int            # 16-byte chunks of its row each lane holds (1 or 2)
    rows_per_thread: int   # rows a thread updates at the same columns (1, 2, 4)
    warps: int             # warps of a block
    grid: int              # blocks along P; the launch grid is (grid, H, B)


@functools.lru_cache(maxsize=1024)
def ssd_plan(B: int, H: int, P: int, N: int, n_sm: int,
             rows_per_thread: Optional[int] = None,
             warps: int = WARPS) -> SsdPlan:
    """How the kernel covers the (B, H, P, N) state on n_sm SMs: a row is
    served by min(32, N / 4) lanes (a power of two), each holding one or two
    16-byte chunks of it; a thread takes 4, 2 or 1 rows, the most that
    still gives the grid MIN_BLOCKS_PER_SM blocks an SM.
    ``rows_per_thread`` and ``warps`` override the choice (the probe's
    sweep)."""
    nc = N // 4
    lanes = next(n for n in (32, 16, 8, 4) if nc >= n or n == 4)
    chunks = math.ceil(nc / lanes)
    per_slot = warps * (32 // lanes)          # rows a block covers per row a thread

    def grid(rpt):
        return math.ceil(P / (per_slot * rpt))
    if rows_per_thread is None:
        rows_per_thread = next((r for r in (4, 2) if B * H * grid(r) >= MIN_BLOCKS_PER_SM * n_sm), 1)
    return SsdPlan(lanes, chunks, rows_per_thread, warps, grid(rows_per_thread))


def ssd_rows(plan: SsdPlan, block: int, thread: int) -> list:
    """The rows of P (unclipped) that thread ``thread`` of block ``block``
    (along P) updates, as the kernel indexes them."""
    per_slot = plan.warps * (32 // plan.lanes)
    p0 = (block * plan.rows_per_thread * per_slot + (thread // 32) * (32 // plan.lanes)
          + (thread % 32) // plan.lanes)
    return [p0 + k * per_slot for k in range(plan.rows_per_thread)]


def ssd_columns(plan: SsdPlan, N: int, thread: int) -> list:
    """The first columns of the 16-byte chunks of its rows that thread
    ``thread`` holds."""
    sub = thread % 32 % plan.lanes
    return [c for c in ((sub + j * plan.lanes) * 4 for j in range(plan.chunks)) if c < N]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_update")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_update_launch.argtypes = [p, p, ll, p, p, p, ll, p, ll, p, p,
                                      i, i, i, i, i, i, i, i, i, i, i, p]
    lib.ssd_update_launch.restype = i
    return lib


def _check(h, x, dt, A, Bm, Cm, out):
    if h.dim() != 4 or x.dim() != 3 or Bm.dim() != 3 or Cm.shape != Bm.shape:
        raise ValueError(f"want h (B,H,P,N), x (B,H,P), Bm/Cm (B,G,N); got "
                         f"{tuple(h.shape)}, {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, P, N = h.shape
    G = Bm.shape[1]
    if (tuple(x.shape) != (B, H, P) or tuple(dt.shape) != (B, H)
            or tuple(A.shape) != (H,) or Bm.shape[0] != B or Bm.shape[2] != N
            or H % G):
        raise ValueError(f"shapes do not match h {tuple(h.shape)}: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}")
    if N % 4 or not MIN_N <= N <= MAX_N:
        raise ValueError(f"kernel takes N a multiple of 4 from {MIN_N} to "
                         f"{MAX_N}; got N={N}")
    if h.dtype != torch.float32 or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise TypeError(f"h, dt and A must be f32; got {h.dtype}, {dt.dtype}, "
                        f"{A.dtype}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share bf16 or f32; got {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    if out is not None and (out.shape != h.shape or out.dtype != h.dtype):
        raise ValueError(f"out must be {tuple(h.shape)} f32")
    for name, t in (("h", h), ("x", x), ("dt", dt), ("A", A), ("Bm", Bm),
                    ("Cm", Cm), ("out", out)):
        if t is not None and t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    for name, t in (("h", h), ("dt", dt), ("A", A), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # inner dims contiguous; the batch dim may carry any stride
    if x.stride(2) != 1 or x.stride(1) != P:
        raise ValueError("x must be contiguous within a batch row")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.stride(2) != 1 or t.stride(1) != N:
            raise ValueError(f"{name} must be contiguous within a batch row")
    for name, t in (("h", h), ("out", out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _dt.check_pointers("ssd_update", (("h", h), ("x", x), ("dt", dt), ("A", A),
                                      ("Bm", Bm), ("Cm", Cm), ("out", out)))


def ssd_update(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
               out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 decode-step state update.

    h (B,H,P,N) f32; x (B,H,P); dt (B,H) f32 post-softplus; A (H,) f32
    negative; Bm/Cm (B,G,N) with G | H, x/Bm/Cm bf16 or f32.  Returns
    (h', y (B,H,P) f32), the SSD inner math of the Mamba2 decode step
    before the D skip and the gating; h' is ``out`` when given (``h``
    for the in-place update), else a new tensor.

    DTensors run on their local shards (``_dtensor.local_call``): batch,
    heads (with their groups of Bm / Cm) and P may stay split; a split N
    is all-gathered first.  With ``out`` the new state is copied into it
    in its own layout."""
    if _dt.any_dtensor(h, x, dt, A, Bm, Cm, out):
        h_new, y = _dt.local_call(ssd_update,
                                  [(h, "bhp."), (x, "bhp"), (dt, "bh"), (A, "h"),
                                   (Bm, "bh."), (Cm, "bh.")],
                                  ["bhp.", "bhp"])
        if out is not None:
            out.copy_(h_new.redistribute(out.device_mesh, out.placements))
            h_new = out
        return h_new, y
    if h.device.type == "cpu":
        h_new, y = ref.ssd_update_ref(h, x, dt, A, Bm, Cm)
        if out is not None:
            out.copy_(h_new)
            h_new = out
        return h_new, y
    if h.device.type == "meta":
        # the dry run's shapes: no data, nothing computed
        B, H, P, _ = h.shape
        return (torch.empty_like(h) if out is None else out,
                torch.empty((B, H, P), dtype=torch.float32, device="meta"))
    if h.device.type != "cuda":
        raise ValueError(f"no ssd_update for device {h.device}")
    _check(h, x, dt, A, Bm, Cm, out)
    B, H, P, N = h.shape
    if out is None:
        out = torch.empty_like(h)
    y = torch.empty((B, H, P), dtype=torch.float32, device=h.device)
    plan = ssd_plan(B, H, P, N, _build.sm_count(h.device.index))
    lib = _lib()
    with torch.cuda.device(h.device):
        rc = lib.ssd_update_launch(
            h.data_ptr(), x.data_ptr(), x.stride(0), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Bm.stride(0), Cm.data_ptr(),
            Cm.stride(0), out.data_ptr(), y.data_ptr(), B, H, P, N,
            Bm.shape[1], int(x.dtype == torch.bfloat16), *plan,
            torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "ssd_update")
    global launches
    launches += 1
    return out, y

