"""Wrappers for the RMSNorm kernels (``csrc/rmsnorm.cu``): the forward
and its gradient.

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor
takes the plain version in ``ref.py``.  ``launches`` counts forward
launches and ``bwd_launches`` backward ones (one per call that reached
the card; a call recorded into a CUDA graph counts once, at capture).
The kernels launch on the current stream and the wrappers allocate only
the outputs and the backward's scratch, so a call can be captured into a
CUDA graph (the backward's tickets, one set per device, are allocated
at its first call with w).  How the forward spreads rows over warps,
blocks and the grid is ``norm_plan``'s, the backward's ``bwd_plan``'s,
from the shapes and the SM count.

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

BWD_THREADS = 256     # most threads of a backward block (kBwdThreads)
BWD_MAX_CHUNKS = 8    # 16-byte chunks of a row a backward lane holds
BWD_MAX_WARPS = 8     # warps of a backward row
BWD_CHUNKS = 2        # the chunks a backward lane holds where 8 warps allow it
BWD_MAX_CLUSTER = 8   # blocks of a cluster (kBwdMaxCluster): the tickets
BWD_CLUSTER = 8       # the blocks of a cluster a plan takes
# (BWD_CHUNKS and BWD_CLUSTER: the fastest of the probe's sweep over 2, 4
# and 8 chunks and clusters of 4 and 8 at R 2048 x D 1536 / 2048 / 3584
# bf16: PERF.md, row 5b)

launches = 0
bwd_launches = 0
_tickets = {}         # device index -> int32 (BWD_MAX_CLUSTER,), all 0 between calls


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
    lib.rmsnorm_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, i, ctypes.c_float,
                                       i, i, i, i, i, i, p]
    lib.rmsnorm_bwd_launch.restype = i
    lib.rmsnorm_bwd_occupancy.argtypes = [i, i, i, i, i, p]
    lib.rmsnorm_bwd_occupancy.restype = i
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


class BwdPlan(NamedTuple):
    warps: int     # warps that own one row
    groups: int    # rows a block holds at once, one per warp group
    chunks: int    # 16-byte chunks of its row each lane holds
    grid: int      # blocks, a multiple of cluster; block b's group g takes
    #                rows b * groups + g + k * grid * groups
    cluster: int   # blocks of a cluster; block k of it adds slice k of dw's
    #                columns over the cluster's groups, pushed to its shared
    #                memory


def bwd_blocks_per_sm(chunks: int) -> int:
    """Backward blocks an SM the kernel's registers allow at ``chunks``
    chunks a lane (its ``bwd_min_blocks``)."""
    return 2 if chunks <= 4 else 1


@functools.lru_cache(maxsize=1024)
def bwd_plan(R: int, D: int, itemsize: int, n_sm: int, chunks: Optional[int] = None,
             blocks_per_sm: Optional[int] = None, cluster: int = BWD_CLUSTER,
             max_clusters: Optional[int] = None) -> BwdPlan:
    """How the backward kernel covers R rows of D elements of ``itemsize``
    bytes on n_sm SMs: the fewest warps a row (at most BWD_MAX_WARPS)
    that hold it at ``chunks`` (default BWD_CHUNKS) 16-byte chunks a lane,
    more chunks (at most BWD_MAX_CHUNKS) past 8 warps; as many groups as
    BWD_THREADS threads hold; a persistent grid of at most
    ``blocks_per_sm`` blocks an SM (default: what the registers allow at
    those chunks) in clusters of ``cluster``, and at most
    ``max_clusters`` clusters (what the card holds at once, which its
    GPCs may cut below n_sm * blocks_per_sm / cluster: ``card_bwd_plan``).
    The other overrides are the probe's sweep.  Raises ValueError for a
    row of more than 2048 chunks (D 16384 bf16, 8192 f32) or a cluster
    past BWD_MAX_CLUSTER."""
    nvec = D * itemsize // 16
    warps = min(BWD_MAX_WARPS, max(1, math.ceil(nvec / (32 * (chunks or BWD_CHUNKS)))))
    c = math.ceil(nvec / (32 * warps))
    if c > BWD_MAX_CHUNKS:
        raise ValueError(f"rows of {nvec} 16-byte chunks do not fit "
                         f"{BWD_MAX_WARPS} warps of at most {BWD_MAX_CHUNKS} "
                         "chunks a lane")
    if not 1 <= cluster <= BWD_MAX_CLUSTER:
        raise ValueError(f"clusters of 1 to {BWD_MAX_CLUSTER} blocks; got {cluster}")
    groups = BWD_THREADS // (32 * warps)
    per_sm = blocks_per_sm or bwd_blocks_per_sm(c)
    fit = n_sm * per_sm // cluster
    if max_clusters is not None:
        fit = min(fit, max_clusters)
    clusters = max(1, min(math.ceil(math.ceil(R / groups) / cluster), fit))
    return BwdPlan(warps, groups, c, clusters * cluster, cluster)


@functools.lru_cache(maxsize=256)
def _occupancy(index: int, is_bf16: int, chunks: int, threads: int, smem: int,
               cluster: int) -> Tuple[int, int, int, int]:
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        _build.check(_lib().rmsnorm_bwd_occupancy(is_bf16, chunks, threads, smem,
                                                  cluster, out), "rmsnorm_bwd_occupancy")
    return tuple(out)


def card_bwd_plan(R: int, D: int, itemsize: int, index: int, with_w: bool = True) -> BwdPlan:
    """``bwd_plan`` on CUDA device ``index``: its SM count, the blocks an
    SM and the clusters the card holds at once for the plan's kernel
    instance (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaOccupancyMaxActiveClusters``), so no cluster waits for a second
    wave.  Without w no block writes to another's shared memory:
    clusters of 1."""
    n_sm = _build.sm_count(index)
    over = {} if with_w else {"cluster": 1}
    plan = bwd_plan(R, D, itemsize, n_sm, **over)
    blocks, held, _, _ = _occupancy(index, int(itemsize == 2), plan.chunks,
                                    32 * plan.warps * plan.groups,
                                    bwd_smem(plan, D) if with_w else 0, plan.cluster)
    return bwd_plan(R, D, itemsize, n_sm, blocks_per_sm=blocks, max_clusters=held, **over)


def bwd_smem(plan: BwdPlan, D: int) -> int:
    """Dynamic shared memory of a backward block with w: the parts of its
    slice of dw that the cluster's groups push to it, cluster x groups x
    ceil(D / 4 / cluster) float4."""
    return plan.cluster * plan.groups * math.ceil(D // 4 / plan.cluster) * 16


def bwd_rows_of(plan: BwdPlan, R: int, block: int, group: int) -> range:
    """The rows group ``group`` of block ``block`` differentiates, in the
    order the kernel walks them (and adds them into its part of dw)."""
    return range(block * plan.groups + group, R, plan.grid * plan.groups)


def bwd_chunks_of(plan: BwdPlan, nvec: int, lane: int) -> list:
    """The 16-byte chunks of a row that lane ``lane`` of its group holds."""
    span = 32 * plan.warps
    return [lane + j * span for j in range(plan.chunks) if lane + j * span < nvec]


def dw_sums(plan: BwdPlan, D: int):
    """The kernel's order of adding dw, by float4 columns (column q holds
    elements 4q..4q+3): yields (columns, terms) for each run of columns
    that the last block of a cluster rank's slice adds alike, terms the
    (block, group) parts in the order they are added: thread sets over
    the clusters (cluster p in set p mod sets), within a cluster its
    blocks in rank order, within a block its groups in order."""
    threads = 32 * plan.warps * plan.groups
    Q, n_cl = D // 4, plan.grid // plan.cluster
    per = math.ceil(Q / plan.cluster)
    for rank in range(plan.cluster):
        q0 = min(Q, rank * per)
        q1 = min(Q, q0 + per)
        for c0 in range(q0, q1, threads):
            n = min(threads, q1 - c0)
            sets = threads // n
            yield range(c0, c0 + n), [(p * plan.cluster + b, g)
                                      for s in range(sets) for p in range(s, n_cl, sets)
                                      for b in range(plan.cluster) for g in range(plan.groups)]


def bwd_occupancy(plan: BwdPlan, itemsize: int, D: int) -> dict:
    """What the card makes of ``plan``'s kernel instance with w: blocks an
    SM, clusters resident at once, registers and local (spill) bytes a
    thread (``rmsnorm_bwd_occupancy``; the probe's report)."""
    threads = 32 * plan.warps * plan.groups
    blocks, held, regs, local = _occupancy(
        torch.cuda.current_device(), int(itemsize == 2), plan.chunks, threads,
        bwd_smem(plan, D), plan.cluster)
    return dict(blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32, max_clusters=held,
                registers=regs, local_bytes=local)


def rmsnorm_bwd(x: torch.Tensor, w: Optional[torch.Tensor], dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``rmsnorm`` at x (..., D), w (D,) or None, for the
    output's gradient dy (x's shape): (dx in x's shape and dtype, dw in
    w's dtype or None), computed in f32 (``ref.rmsnorm_bwd_ref``'s
    formulas).  On the card: one launch of the backward kernel
    (``card_bwd_plan``), whose blocks add their parts of dw in a fixed
    order (pushed into each cluster's shared memory, then the last block
    of each slice of columns by ticket); no atomic on a value, so
    repeated calls give the same bits.  The first call with w on a device
    allocates the kernel's tickets and must not be under CUDA-graph
    capture.  x and dy are read contiguous (copied first when they are
    not).  DTensors run on their local rows; dw of
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
    plan = card_bwd_plan(R, D, x.element_size(), x.device.index, w is not None)
    part = tickets = None
    if w is not None:   # the clusters' parts of dw, and the slices' tickets
        part = torch.empty((plan.grid // plan.cluster, D), dtype=torch.float32,
                           device=x.device)
        tickets = _build.ticket_buffer(_tickets, x.device, BWD_MAX_CLUSTER,
                                       "rmsnorm_bwd")
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_bwd_launch(
            x2.data_ptr(), dy2.data_ptr(), None if w is None else w.data_ptr(),
            dx.data_ptr(), None if dw is None else dw.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            R, D, eps, int(x.dtype == torch.bfloat16), *plan,
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
