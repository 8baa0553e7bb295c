#!/usr/bin/env python3
"""Where kernels 4 (``ssd_update``) and 5 (``rmsnorm``) spend their time on
one NVIDIA card, at the shapes the main paths give them: kernel 4 at the
mamba2-2.7b (1, 80, 64, 128) and zamba2-1.2b (1, 64, 64, 64) batch-1
decode shapes (f32 x/B/C, in place, as the model calls it); kernel 5 in
bf16 with w at R 1 (a decode row) and 2048 (a prompt) x D 2560, 3584,
5120.

    PYTHONPATH=src python3 scripts/ssd_rmsnorm_probe.py [--parent DIR] [--only NAME]

For each shape and each tree (this one, then every ``--parent``) it
prints, through the tree's own wrapper:

- ``ms``: chip_smoke's Timer (CUDA-event median of 30 runs after 5
  warm-ups, 256 MB written before each run, a spin while the host
  enqueues the run);
- ``device_us``: torch.profiler's device time per call (20 calls, the
  flush before each left out of the sum), and the kernels it saw;
  ``clean_device_us`` the same after a flush that reads 256 MB, so the
  call writes back no dirty line the flush left in L2, and
  ``warm_device_us`` with no flush, the inputs in L2 as a decode step
  finds the rows its previous kernel wrote;
- ``host_us``: the wrapper's host time per call (200 calls, not
  synchronised);
- ``b2b_us``: the time per call back to back and cold, one event pair
  around calls enqueued behind one spin after an L2 flush: kernel 4 over
  64 distinct mamba2 states (168 MB) or 96 zamba2 states (101 MB), each
  updated in place; kernel 5 over 8 distinct R=2048 inputs, or 129
  distinct decode rows (a mamba2 step's norms);
- ``turns``: the Timer of this tree and each parent in turns (parent,
  kernel, kernel, parent); for kernel 5 also ``F.rms_norm`` on the same
  inputs in turns with the kernel (kernel, F, F, kernel), with its
  device time and back-to-back time (timed only, never used by the port).

``--only rmsnorm_bwd`` times kernel 5's backward instead (bf16 with w,
R 2048 x D 1536, 2048, 3584: qwen2-vl, qwen2.5-3b, qwen2.5-7b) through
each tree's ``rmsnorm_bwd`` and ``F.rms_norm``'s backward under autograd
on the same inputs: ``ms`` by the Timer above, and ``device_us`` split
by kernel (the profiler; each kernel's device time per call, the
flush's own kernel subtracted), beside each backward kernel's registers
a thread and local bytes (``cuobjdump -res-usage`` of the tree's
library) and its theoretical occupancy (resident warps of 64 an SM,
from registers, threads and shared memory), and, for a tree whose
library has ``rmsnorm_bwd_occupancy``, the blocks an SM and the
clusters the card holds at once (``cudaOccupancyMaxActiveBlocksPer
Multiprocessor`` / ``MaxActiveClusters``).  ``in turns`` rows time each
parent against this tree (parent, kernel, kernel, parent) and
``F.rms_norm`` against the kernel; ``sweep`` rows (a tree whose
``bwd_plan`` takes overrides) time the kernel at other plans: chunks a
lane, blocks an SM, blocks a cluster.  The copies of this tree's source
in BWD_VARIANTS stop early (``rows_only``: no dw stage; ``no_ticket``:
the cluster's slice written, no ticket and no last pass; timed only) or
change the cache hints or the blocks an SM, and a timeline copy stamps
each block's phases (BWD_STAMPS), all with ``--only rmsnorm_bwd``.  With
``--step`` each tree also trains one eager qwen2.5-3b step at full width
(chip_smoke phase 18c's cell) in a process of its own, in turns, and
reports kernel 5's backward's launches and device us in it.

Variants are copies of a tree's source with textual edits, built into
``build/probe/`` and called through that tree's wrapper with its
``_lib`` swapped.  Each variant lists alternative edit sets; the first
whose anchors all lie in the source is made, and a source that has none
skips it.  The ablations give wrong outputs and are timed only:

- kernel 4 ``no_bc`` (B and C not read: constants), ``no_store`` (h'
  not written; y still is), ``no_math`` (h' = h: no exp, no products);
- kernel 5 ``no_store`` (y not written), ``two_pass`` (x read a second
  time for the output pass, as the kernel's first version did);
- both ``stream_hints`` (right outputs): the streaming loads and stores
  (``__ldcs`` / ``__stcs``) on the state or the rows.

A ``timeline`` copy stamps %globaltimer in thread 0 of every block at
its entry, when its first loaded value is in, and after its last store
is issued (one call, L2 flushed): the median and the last block, us
since the first entry.  ``sweep`` rows (a tree whose wrapper has
``ssd_plan`` / ``norm_plan``) time the kernel at other plans: rows per
thread and warps per block for kernel 4, warps per row for kernel 5.
Writes everything to ``chiprun_out/ssd_rmsnorm_probe.json``.  Needs nvcc
and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from decode_attention_probe import host_us  # noqa: E402  (this script's folder)
from int4_gemv_probe import timed  # noqa: E402
from paged_attention_probe import TIMELINE_HEAD, TIMELINE_TAIL, compile_copy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402
from repro_torch.kernels.ssd_update import ref as ssd_ref  # noqa: E402

OUT = ROOT / "chiprun_out"
KERNELS = ("ssd_update", "rmsnorm")
PARTS = KERNELS + ("rmsnorm_bwd",)
LAUNCH = {"ssd_update": "ssd_update_launch", "rmsnorm": "rmsnorm_launch",
          "rmsnorm_bwd": "rmsnorm_bwd_launch"}
SSD_SHAPES = {"mamba2-2.7b": ((1, 80, 64, 128, 1), 64),   # (B, H, P, N, G), states b2b
              "zamba2-1.2b": ((1, 64, 64, 64, 1), 96)}
NORM_SHAPES = [(R, D) for R in (1, 2048) for D in (2560, 3584, 5120)]
NORM_B2B = {1: 129, 2048: 8}        # decode rows of a mamba2 step; prompts past L2
BWD_SHAPES = [(2048, D) for D in (1536, 2048, 3584)]   # qwen2-vl, qwen2.5-3b, qwen2.5-7b
BWD_SWEEP = dict(chunks=(2, 4, 8), blocks_per_sm=(1, 2, 3), cluster=(4, 8))
NEVER = "-1.2345e30f"               # a guard no value meets: the store is kept in the code

VARIANTS = {   # kernel: variant: alternative edit sets, each [(old, new), ...]
    "ssd_update": {
        "no_bc": [
            [("    b_s[i] = to_f(bv[i]);\n    c_s[i] = to_f(cv[i]);",
              "    b_s[i] = 1.f;\n    c_s[i] = 0.5f;")],
            [("      load4(bv + c, vec, bb[j]);\n      load4(cv + c, vec, cc[j]);",
              "      bb[j] = make_float4(1.f, 1.f, 1.f, 1.f);\n"
              "      cc[j] = make_float4(.5f, .5f, .5f, .5f);")]],
        "no_store": [
            [("      *reinterpret_cast<float4*>(h_out + base + c) = o;",
              f"      if (o.x == {NEVER}) *reinterpret_cast<float4*>(h_out + base + c) = o;")],
            [("        store_state(h_out + row + c, o);",
              f"        if (o.x == {NEVER}) store_state(h_out + row + c, o);")]],
        "no_math": [
            [("  return __fadd_rn(__fmul_rn(decay, h), __fmul_rn(xdt, b));", "  return h;")]],
        "stream_hints": [
            [("  return *reinterpret_cast<const float4*>(p);", "  return __ldcs(reinterpret_cast<const float4*>(p));"),
             ("  *reinterpret_cast<float4*>(p) = v;", "  __stcs(reinterpret_cast<float4*>(p), v);")]],
    },
    "rmsnorm": {
        "no_store": [
            [("    store<T, V>(yr + (size_t)i * V, o);",
              f"    if (o[0] == {NEVER}) store<T, V>(yr + (size_t)i * V, o);")],
            [("        st_row(yr + (size_t)i * V, pack<T>(o));",
              f"        if (o[0] == {NEVER}) st_row(yr + (size_t)i * V, pack<T>(o));")]],
        "two_pass": [
            [("    // scale the row held in registers\n",
              "    // scale the row held in registers\n"
              "#pragma unroll\n    for (int j = 0; j < C; ++j)\n"
              "      if (lo + j * span < nvec) xv[j] = ld_row(xr + (size_t)(lo + j * span) * V);\n")]],
        "stream_hints": [
            [("  return *reinterpret_cast<const uint4*>(p);", "  return __ldcs(reinterpret_cast<const uint4*>(p));"),
             ("  *reinterpret_cast<uint4*>(p) = v;", "  __stcs(reinterpret_cast<uint4*>(p), v);")]],
    },
}

# Kernel 5's backward (``--only rmsnorm_bwd``), timed only: each copy
# stops where it says, behind a test of eps that the compiler cannot
# fold (eps > 0 in every call), so the code after it is still compiled.
BWD_VARIANTS = {
    "rows_only": [[("  if (w == nullptr) return;\n",
                    "  if (w == nullptr) return;\n  if (eps > 0.f) return;\n")]],
    "no_ticket": [[("  if (tid == 0) {     // release: the slice's row p; acquire: the other rows\n",
                    "  if (eps > 0.f) return;\n"
                    "  if (tid == 0) {     // release: the slice's row p; acquire: the other rows\n")]],
}
# and copies with other cache hints on the rows (right outputs): x and dy
# read through L1 (``l1_loads``) or as streaming (``ldcs``), dx written as
# streaming (``stcs``)
_BWD_LOADS = [
    ("        xv[j] = ld_once(x + (size_t)r * D + (size_t)(lo + j * span) * V);\n"
     "        dv[j] = ld_once(dy + (size_t)r * D + (size_t)(lo + j * span) * V);\n"),
    ("          xn[j] = ld_once(x + next + (size_t)(lo + j * span) * V);\n"
     "          dn[j] = ld_once(dy + next + (size_t)(lo + j * span) * V);\n")]
_BWD_HEAD = "// blockDim.x = 32 * warps * groups; chunks C cover the row: C * 32 *\n"
BWD_VARIANTS["l1_loads"] = [[(old, old.replace("ld_once(", "ld_row(")) for old in _BWD_LOADS]]
BWD_VARIANTS["ldcs"] = [[
    (_BWD_HEAD, "__device__ __forceinline__ uint4 ld_cs(const void* p) {\n"
                "  return __ldcs(reinterpret_cast<const uint4*>(p));\n}\n" + _BWD_HEAD)]
    + [(old, old.replace("ld_once(", "ld_cs(")) for old in _BWD_LOADS]]
BWD_VARIANTS["stcs"] = [[("        st_row(dxr + (size_t)i * V, pack<T>(o));\n",
                          "        __stcs(reinterpret_cast<uint4*>(dxr + (size_t)i * V), "
                          "pack<T>(o));\n")]]

# and a copy whose registers allow 3 blocks an SM at 2 chunks a lane, run
# at 3 blocks an SM (the plan's overrides beside each variant)
BWD_VARIANTS["three_blocks"] = [[(
    "__host__ __device__ constexpr int bwd_min_blocks(int C) { return C <= 4 ? 2 : 1; }",
    "__host__ __device__ constexpr int bwd_min_blocks(int C) { return C <= 2 ? 3 : C <= 4 ? 2 : 1; }")]]
BWD_VARIANT_PLANS = {"three_blocks": dict(blocks_per_sm=3, max_clusters=45)}

# Kernel 5's backward's timeline copy (thread 0 of each block), stamped as
# STAMPS below.
BWD_STAMPS = [[
    ("entry", "  const int q0 = min(Q, (int)rank * per), q1 = min(Q, q0 + per);\n", True, None),
    ("rows done", "  }   // rows\n  if (w == nullptr) return;\n", True, None),
    ("part pushed", "  mbar_wait(&bar, 0);\n", False, None),
    ("cluster's parts in", "  mbar_wait(&bar, 0);\n", True, None),
    ("cluster's slice written",
     "  if (tid == 0) {     // release: the slice's row p; acquire: the other rows\n", False, None),
    ("ticket taken", "    last_s = prev == P - 1;\n  }\n  __syncthreads();\n", True, None),
    ("slice of dw written", "  if (tid == 0) tickets[rank] = 0;\n", True, None)]]

# The timeline copy: (point, anchor, stamp after the anchor, condition or
# None).  "first load in" tests a value computed from the loads, so the
# stamp waits for them.
STAMPS = {
    "ssd_update": [
        [("entry", "  const int head = blockIdx.y, b = blockIdx.z;\n", True, None),
         ("first load in", "      acc += o.x * cc.x + o.y * cc.y + o.z * cc.z + o.w * cc.w;\n",
          True, f"c == sub * 4 && acc != {NEVER}"),
         ("last store", "  if (p < P && sub == 0) y[((size_t)b * H + head) * P + p] = acc;\n",
          True, None)],
        [("entry", "  const int head = blockIdx.y, b = blockIdx.z;\n", True, None),
         ("first load in", "    // y of the row: a shuffle reduction over its lanes\n", True,
          f"k == 0 && acc != {NEVER}"),
         ("last store", "  }   // rows\n", True, None)]],
    "rmsnorm": [
        [("entry", "  T* yr = y + (size_t)blockIdx.x * D;\n", True, None),
         ("first load in", "  if (lane == 0) warp_sums[warp] = ss;\n", False, None),
         ("last store", "    store<T, V>(yr + (size_t)i * V, o);\n  }\n", True, None)],
        [("entry", "  int r = blockIdx.x * rows_per_block + group;\n", True, None),
         ("first load in", "    // the row's sum of squares is in\n", True,
          f"r == blockIdx.x * rows_per_block + group && ss != {NEVER}"),
         ("last store", "  }   // rows\n", True, None)]],
}


def edited(text: str, alternatives):
    """``text`` with the first alternative edit set whose anchors all lie
    in it, or None."""
    for edits in alternatives:
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            return text
    return None


def stamped(text: str, alternatives):
    """``text`` with a STAMP(k) at each point of the first stamp set whose
    anchors all lie in it once, or None."""
    for stamps in alternatives:
        if all(text.count(anchor) == 1 for _, anchor, _, _ in stamps):
            for k, (_, anchor, after, cond) in enumerate(stamps):
                stamp = f"  if ({cond}) STAMP({k});\n" if cond else f"  STAMP({k});\n"
                text = text.replace(anchor, anchor + stamp if after else stamp + anchor)
            head = text.index("namespace {")
            return text[:head] + TIMELINE_HEAD + text[head:] + TIMELINE_TAIL, stamps
    return None


def tree_ops(root: Path) -> dict:
    """The wrappers of kernels 4 and 5 in the checkout at ``root``."""
    if root == ROOT:
        return {k: importlib.import_module(f"repro_torch.kernels.{k}.ops") for k in KERNELS}
    sys.path[:0] = [str(root / "src")]
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m.startswith("repro_torch")}
    try:
        return {k: importlib.import_module(f"repro_torch.kernels.{k}.ops") for k in KERNELS}
    finally:
        sys.path.pop(0)
        for m in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[m]
        sys.modules.update(saved)


def build_variants(trees: dict, kernels=KERNELS) -> dict:
    """Every variant and timeline copy of every tree's sources of
    ``kernels``, built in parallel: {(tree, kernel): {variant: (cdll,
    stamps or None)}}."""
    jobs = {}
    for tag, (root, _) in trees.items():
        for kernel in kernels:
            text = (root / "src" / "repro_torch" / "csrc" / f"{kernel}.cu").read_text()
            for variant, alts in VARIANTS[kernel].items():
                made = edited(text, alts)
                if made is not None:
                    jobs[(tag, kernel, variant)] = (made, None)
            made = stamped(text, STAMPS[kernel])
            if made is not None:
                jobs[(tag, kernel, "timeline")] = made
    names = {key: "_".join([key[0].split()[0], str(i), key[1], key[2]])
             for i, key in enumerate(jobs)}
    with ThreadPoolExecutor(8) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda key: compile_copy(jobs[key][0], names[key], f"{key[1]}_kernel"), jobs)))
    out = {}
    for (tag, kernel, variant), cdll in libs.items():
        if variant == "timeline":
            cdll.probe_ts_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        out.setdefault((tag, kernel), {})[variant] = (cdll, jobs[(tag, kernel, variant)][1])
    return out


@contextmanager
def swapped(ops, kernel: str, cdll):
    """Calls of ``ops``' wrapper launch ``cdll``'s kernel (the argument
    types of the tree's own library)."""
    real = ops._lib()
    fn, rfn = getattr(cdll, LAUNCH[kernel]), getattr(real, LAUNCH[kernel])
    fn.argtypes, fn.restype = rfn.argtypes, rfn.restype
    saved = ops._lib
    ops._lib = lambda: cdll
    try:
        yield
    finally:
        ops._lib = saved


@contextmanager
def patched(ops, name: str, **override):
    """``ops.<name>`` (a plan function) called with ``override``."""
    saved = getattr(ops, name)
    setattr(ops, name, lambda *a, **k: saved(*a, **{**k, **override}))
    try:
        yield saved
    finally:
        setattr(ops, name, saved)


def device_us(fn, flush, iters: int = 20, mode: str = "dirty"):
    """torch.profiler device time per call (us) of every kernel but the
    flush's (averaged over the calls the profiler recorded), and the
    names of those kernels.  Before each call the flush writes 256 MB
    ("dirty": L2 left full of dirty lines, as chip_smoke's Timer leaves
    it) or reads them ("clean": no line left to write back); "warm" does
    no flush, so the call finds its inputs in L2, as a decode step finds
    the rows its previous kernel wrote."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if mode == "dirty":
                flush.zero_()
            elif mode == "clean":
                flush.view(torch.float32).sum()
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and not any(k in e.key.lower() for k in ("fill", "memset", "reduce"))]
    calls = max((e.count for e in seen), default=0)
    return (sum(e.self_device_time_total for e in seen) / calls if calls else float("nan"),
            sorted({e.key[:90] for e in seen}))


def back_to_back(calls, flush, reps: int = 7) -> float:
    """us per call of ``calls`` enqueued behind one spin (long enough for
    the host to enqueue them all) between one event pair, L2 flushed
    first: the card runs them back to back, each finding its data cold."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(20_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for c in calls:
            c()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / len(calls) * 1e3


def timeline(cdll, stamps, run, flush) -> dict:
    """One call after warm-up, L2 flushed: per point, the median and the
    last block's time (us) since the first block's entry."""
    run()
    cdll.probe_ts_clear()
    flush.zero_()
    torch.cuda._sleep(2_000_000)
    run()
    torch.cuda.synchronize()
    buf = np.zeros(1 << 16, dtype=np.uint64)
    _build.check(cdll.probe_ts_read(buf.ctypes.data, buf.size), "probe_ts_read")
    ts = buf.reshape(-1, 8).astype(np.float64)
    ts = ts[ts[:, 0] > 0]
    t0 = ts[:, 0].min()
    out = {}
    for k, (name, _, _, _) in enumerate(stamps):
        hit = ts[:, k] > 0
        if hit.any():
            rel = (ts[hit, k] - t0) / 1e3
            out[name] = dict(blocks=int(hit.sum()), median_us=float(np.median(rel)),
                             max_us=float(rel.max()))
    return out


def split_us(fn, flush, iters: int = 20, clean: bool = False) -> dict:
    """torch.profiler device time per call (us) of each kernel ``fn``
    launches, L2 flushed before each call: 256 MB written (L2 left full
    of dirty lines, as chip_smoke's Timer leaves it) or, with ``clean``,
    read; the flush's own kernels, profiled alone first, are subtracted
    by name."""
    from torch.profiler import ProfilerActivity, profile
    wipe = (lambda: flush.view(torch.float32).sum()) if clean else flush.zero_

    def per_call(f):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                f()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / iters for e in prof.key_averages()
                if e.self_device_time_total > 0}
    own = per_call(wipe)
    both = per_call(lambda: (wipe(), fn()))
    out = {k[:90]: v - own.get(k, 0.0) for k, v in both.items()}
    return {k: v for k, v in out.items() if v > 0.05}


def res_usage(lib: Path, names=("rmsnorm_bwd", "rmsnorm_dw_reduce")) -> dict:
    """Registers a thread, local (spill) and static shared bytes of each
    kernel instance in ``lib`` whose name holds one of ``names``
    (``cuobjdump -res-usage``)."""
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            fn = line[len("Function "):].rstrip(":")
        elif fn and "REG:" in line and any(n in fn for n in names):
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            out[fn[:80]] = {k: int(fields[k]) for k in ("REG", "LOCAL", "SHARED")
                            if k in fields and fields[k].isdigit()}
    return out


def theoretical_warps(regs: int, threads: int, smem: int) -> int:
    """Resident warps an SM (of 64) for blocks of ``threads`` at
    ``regs`` registers a thread and ``smem`` shared bytes a block:
    registers by warp in units of 256, at most 32 blocks, 2048 threads,
    227 KB of shared memory an SM (1 KB of it reserved a block)."""
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    blocks = min(32, 2048 // (32 * warps), (65536 // per_warp) // warps,
                 (233472 // (smem + 1024)) if smem else 32)
    return blocks * warps


def bwd_inputs(dev, R, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 * torch.randn((R, D), generator=g, device=dev)).bfloat16()
    dy = (torch.randn((R, D), generator=g, device=dev) / 3).bfloat16()
    w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).bfloat16()
    return x, dy, w


def ssd_inputs(dev, B, H, P, N, G, seed, states=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = [torch.randn((B, H, P, N), generator=g, device=dev) for _ in range(states)]
    x = torch.randn((B, H, P), generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((B, H), generator=g, device=dev))
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    Bm = torch.randn((B, G, N), generator=g, device=dev)
    Cm = torch.randn((B, G, N), generator=g, device=dev)
    return hs, (x, dt, A, Bm, Cm)


def norm_inputs(dev, R, D, seed, count=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [(3 * torch.randn((R, D), generator=g, device=dev)).bfloat16() for _ in range(count)]
    w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).bfloat16()
    return xs, w


def main() -> int:
    import torch.nn.functional as F
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    ap.add_argument("--only", choices=PARTS, help="one kernel (rmsnorm_bwd: kernel "
                    "5's backward, timed only when named)")
    ap.add_argument("--step", action="store_true", help="with --only rmsnorm_bwd: "
                    "also profile one qwen2.5-3b training step in each tree")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_rmsnorm_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"kernel": (ROOT, tree_ops(ROOT))}
    for p in a.parent:
        trees[f"parent {p}"] = (p.resolve(), tree_ops(p.resolve()))
    variants = build_variants(trees, KERNELS if a.only is None else
                              tuple(k for k in KERNELS if k == a.only))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    result = {"device": smi, "rows": []}

    def emit(row):
        result["rows"].append(row)
        print(json.dumps(row), flush=True)

    def measure(kernel, shape, call, check, b2b):
        """Base rows of every tree, the turns, the variants, the timelines.
        call(ops): the timed call; check(ops): its max abs error against
        the plain version; b2b(ops): the calls timed back to back."""
        for tag, (_, ops) in trees.items():
            us, seen = device_us(call(ops), flush)
            emit(dict(kernel=kernel, shape=shape, tree=tag, variant="as is",
                      max_abs_err=check(ops), ms=timed(call(ops), flush), device_us=us,
                      clean_device_us=device_us(call(ops), flush, mode="clean")[0],
                      warm_device_us=device_us(call(ops), flush, mode="warm")[0],
                      device_kernels=seen, host_us=host_us(call(ops)),
                      b2b_us=back_to_back(b2b(ops), flush)))
        ops = trees["kernel"][1]
        for tag, (_, old) in list(trees.items())[1:]:
            times = {"parent": [], "kernel": []}
            for who in ("parent", "kernel", "kernel", "parent"):
                times[who].append(timed(call(old if who == "parent" else ops), flush))
            emit(dict(kernel=kernel, shape=shape, tree=tag, variant="in turns",
                      parent_ms=times["parent"], ms=times["kernel"]))
        for tag, (_, tops) in trees.items():
            for variant, (cdll, stamps) in variants.get((tag, kernel), {}).items():
                with swapped(tops[kernel], kernel, cdll):
                    if stamps is not None:
                        emit(dict(kernel=kernel, shape=shape, tree=tag, variant="timeline",
                                  points=timeline(cdll, stamps, call(tops), flush)))
                    else:
                        emit(dict(kernel=kernel, shape=shape, tree=tag, variant=variant,
                                  max_abs_err=check(tops), ms=timed(call(tops), flush),
                                  device_us=device_us(call(tops), flush)[0]))

    if a.only in (None, "ssd_update"):
        for shape, ((B, H, P, N, G), n_states) in SSD_SHAPES.items():
            hs, rest = ssd_inputs(dev, B, H, P, N, G, 99, n_states)
            h0 = hs[0].clone()

            def call(ops, h=hs[0]):   # in place, as the model calls it
                return lambda: ops["ssd_update"].ssd_update(h, *rest, out=h)

            def check(ops):   # out of place on a copy, against the plain version
                got = ops["ssd_update"].ssd_update(h0, *rest)
                return max(float((g - w).abs().max()) for g, w in zip(got, want))
            want = ssd_ref.ssd_update_ref(h0, *rest)
            measure("ssd_update", shape, call, check, lambda ops: [call(ops, h) for h in hs])
            ops = trees["kernel"][1]["ssd_update"]
            if hasattr(ops, "ssd_plan"):
                for warps in (4, 8):
                    for rpt in (1, 2, 4):
                        with patched(ops, "ssd_plan", rows_per_thread=rpt, warps=warps) as plan:
                            fn = call(trees["kernel"][1])
                            emit(dict(kernel="ssd_update", shape=shape, variant="sweep",
                                      plan=plan(B, H, P, N, _build.sm_count(0),
                                                rows_per_thread=rpt, warps=warps)._asdict(),
                                      ms=timed(fn, flush), device_us=device_us(fn, flush)[0],
                                      b2b_us=back_to_back([call(trees["kernel"][1], h)
                                                           for h in hs], flush)))
            del hs, rest, h0

    if a.only in (None, "rmsnorm"):
        for R, D in NORM_SHAPES:
            shape = f"R={R} D={D}"
            if R == 1:     # 129 decode rows of one (129, D) tensor
                xs, w = norm_inputs(dev, NORM_B2B[R], D, R + D)
                rows = [xs[0][i:i + 1] for i in range(NORM_B2B[R])]
            else:
                xs, w = norm_inputs(dev, R, D, R + D, NORM_B2B[R])
                rows = xs
            x = rows[0]
            want = norm_ref.rmsnorm_ref(x, w).float()

            def call(ops, x=x):
                return lambda: ops["rmsnorm"].rmsnorm(x, w)

            def check(ops):
                return float((call(ops)().float() - want).abs().max())
            measure("rmsnorm", shape, call, check, lambda ops: [call(ops, xi) for xi in rows])
            ops = trees["kernel"][1]
            lib = lambda: F.rms_norm(x, (D,), w, eps=1e-6)  # noqa: E731
            times = {"F.rms_norm": [], "kernel": []}
            for who in ("kernel", "F.rms_norm", "F.rms_norm", "kernel"):
                times[who].append(timed(lib if who == "F.rms_norm" else call(ops), flush))
            us, seen = device_us(lib, flush)
            emit(dict(kernel="rmsnorm", shape=shape, variant="F.rms_norm in turns",
                      ms=times["kernel"], library_ms=times["F.rms_norm"], library_device_us=us,
                      library_kernels=seen,
                      library_b2b_us=back_to_back(
                          [lambda xi=xi: F.rms_norm(xi, (D,), w, eps=1e-6) for xi in rows],
                          flush)))
            if hasattr(ops["rmsnorm"], "norm_plan"):
                for wpr in (1, 2, 3, 4, 5, 6, 8, 10, 14, 20):
                    for bps in ((1, 2, 3, 4, 8) if R > 1 else (1,)):
                        try:
                            p = ops["rmsnorm"].norm_plan(R, D, 2, _build.sm_count(0),
                                                         warps_per_row=wpr, blocks_per_sm=bps)
                        except ValueError:
                            continue
                        with patched(ops["rmsnorm"], "norm_plan", warps_per_row=wpr,
                                     blocks_per_sm=bps):
                            fn = call(ops)
                            emit(dict(kernel="rmsnorm", shape=shape, variant="sweep",
                                      plan=p._asdict(), max_abs_err=check(ops),
                                      ms=timed(fn, flush), device_us=device_us(fn, flush)[0],
                                      b2b_us=back_to_back([call(ops, xi) for xi in rows],
                                                          flush)))
            del xs, rows, x
    if a.only == "rmsnorm_bwd":
        probe_bwd(trees, flush, emit, a.step)
    OUT.mkdir(exist_ok=True)
    (OUT / "ssd_rmsnorm_probe.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


# One eager qwen2.5-3b training step at full width (chip_smoke phase 18c's
# cell: bf16, batch 1, seq 2048, remat blocks, AdamW) after two warm-up
# steps, profiled: kernel 5's backward's launches and device us in it.
# Run in a process of its own from each tree's root, so each tree's
# package trains.
STEP_CODE = r"""
import json, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.training import (AdamW, DataCursor, cosine_schedule, make_train_step,
                                  synthetic_batch, trainable)
dev = torch.device("cuda", 0)
cfg = get_config("qwen2.5-3b")
model = Model(cfg, device=dev)
opt = AdamW(lr=cosine_schedule(3e-4, 2, 100))
step = make_train_step(model, opt, remat="blocks")
params = trainable(model.init(torch.Generator(device=dev).manual_seed(0)))
state = (params, opt.init(params))
batches = [synthetic_batch(cfg, DataCursor(7, i), batch=1, seq_len=2048, device=dev)
           for i in range(3)]
for b in batches[:2]:
    state, _ = step(state, b)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    state, _ = step(state, batches[2])
    torch.cuda.synchronize()
picked = [e for e in prof.key_averages() if e.self_device_time_total > 0
          and ("rmsnorm_bwd" in e.key or "rmsnorm_dw_reduce" in e.key)]
total = sum(e.self_device_time_total for e in prof.key_averages() if e.self_device_time_total > 0)
print(json.dumps(dict(kernels={e.key[:60]: [e.count, e.self_device_time_total] for e in picked},
                      device_us=sum(e.self_device_time_total for e in picked),
                      step_device_ms=total / 1e3)))
"""


def step_us(root: Path) -> dict:
    """STEP_CODE run from the tree at ``root``: its JSON line."""
    done = subprocess.run([sys.executable, "-c", STEP_CODE], cwd=root, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    if done.returncode != 0:
        raise RuntimeError(f"training step in {root} failed:\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def probe_bwd(trees: dict, flush, emit, step: bool = False) -> None:
    """Kernel 5's backward in every tree beside ``F.rms_norm``'s
    backward at BWD_SHAPES (see the module's docstring)."""
    import torch.nn.functional as F
    dev = flush.device
    n_sm = _build.sm_count(0)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "rmsnorm.cu").read_text()
    jobs = {v: edited(text, alts) for v, alts in BWD_VARIANTS.items()}
    jobs = {v: t for v, t in jobs.items() if t is not None}
    line = stamped(text, BWD_STAMPS)
    if line is not None:
        jobs["timeline"] = line[0]
    with ThreadPoolExecutor(8) as pool:
        cut = dict(zip(jobs, pool.map(lambda v: compile_copy(jobs[v], f"bwd_{v}",
                                                             "rmsnorm_bwd_kernel"), jobs)))
    if "timeline" in cut:
        cut["timeline"].probe_ts_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for tag, (root, tops) in trees.items():
        ops = tops["rmsnorm"]
        lib = ops._build._lib_path("rmsnorm")
        ops._lib()
        emit(dict(kernel="rmsnorm_bwd", tree=tag, variant="resources",
                  res_usage=res_usage(lib)))
    if step:   # each tree's step in turns: parent, kernel, kernel, parent
        order = list(trees.items())
        order = order[1:] + order[:1] + order[:1] + order[1:] if len(order) > 1 else order
        for tag, (root, _) in order:
            emit(dict(kernel="rmsnorm_bwd", tree=tag, variant="training step", **step_us(root)))
    for R, D in BWD_SHAPES:
        shape = f"R={R} D={D}"
        x, dy, w = bwd_inputs(dev, R, D, 11 * D)
        want_dx, want_dw = norm_ref.rmsnorm_bwd_ref(x, w, dy)

        def call(ops):
            return lambda: ops.rmsnorm_bwd(x, w, dy)

        def check(ops):
            dx, dw = ops.rmsnorm_bwd(x, w, dy)
            dx2, dw2 = ops.rmsnorm_bwd(x, w, dy)
            return dict(dx_err=float((dx.float() - want_dx.float()).abs().max()),
                        dw_err=float((dw.float() - want_dw.float()).abs().max()),
                        repeat_equal=bool(torch.equal(dx, dx2) and torch.equal(dw, dw2)))
        for tag, (root, tops) in trees.items():
            ops = tops["rmsnorm"]
            plan = (ops.card_bwd_plan(R, D, 2, 0) if hasattr(ops, "card_bwd_plan")
                    else ops.bwd_plan(R, D, 2, n_sm))
            row = dict(kernel="rmsnorm_bwd", shape=shape, tree=tag, variant="as is",
                       plan=plan._asdict() if hasattr(plan, "_asdict") else list(plan),
                       **check(ops), ms=timed(call(ops), flush),
                       device_us=split_us(call(ops), flush), host_us=host_us(call(ops)))
            row["device_us_total"] = sum(row["device_us"].values())
            row["clean_device_us_total"] = sum(split_us(call(ops), flush, clean=True).values())
            no_w = lambda: ops.rmsnorm_bwd(x, None, dy)  # noqa: E731
            row["no_w_device_us_total"] = sum(split_us(no_w, flush).values())
            row["no_w_clean_device_us_total"] = sum(split_us(no_w, flush, clean=True).values())
            if hasattr(ops._lib(), "rmsnorm_bwd_occupancy"):
                row["occupancy"] = ops.bwd_occupancy(plan, 2, D)
            else:   # the parent's: blocks of 32 * warps threads, no dynamic shared memory
                regs = next((v["REG"] for k, v in res_usage(ops._build._lib_path("rmsnorm"),
                                                            ("rmsnorm_bwd_kernel",)).items()
                             if f"nv_bfloat16Li{plan[1]}E" in k), None)
                if regs is not None:
                    row["theoretical_warps"] = theoretical_warps(regs, 32 * plan[0], 128)
            emit(row)
        ops = trees["kernel"][1]["rmsnorm"]
        for tag, (_, old) in list(trees.items())[1:]:
            times = {"parent": [], "kernel": []}
            for who in ("parent", "kernel", "kernel", "parent"):
                times[who].append(timed(call(old["rmsnorm"] if who == "parent" else ops), flush))
            emit(dict(kernel="rmsnorm_bwd", shape=shape, tree=tag, variant="in turns",
                      parent_ms=times["parent"], ms=times["kernel"]))
        for variant, cdll in cut.items():
            with swapped(ops, "rmsnorm_bwd", cdll), \
                    patched(ops, "bwd_plan", **BWD_VARIANT_PLANS.get(variant, {})):
                if variant == "timeline":
                    emit(dict(kernel="rmsnorm_bwd", shape=shape, variant=variant,
                              points=timeline(cdll, line[1], call(ops), flush)))
                    continue
                emit(dict(kernel="rmsnorm_bwd", shape=shape, variant=variant,
                          ms=timed(call(ops), flush),
                          device_us_total=sum(split_us(call(ops), flush).values())))
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = F.rms_norm(xr, (D,), wr, eps=1e-6)
        lib = lambda: torch.autograd.grad(y, (xr, wr), dy, retain_graph=True)  # noqa: E731
        times = {"F.rms_norm": [], "kernel": []}
        for who in ("kernel", "F.rms_norm", "F.rms_norm", "kernel"):
            times[who].append(timed(lib if who == "F.rms_norm" else call(ops), flush))
        split = split_us(lib, flush)
        emit(dict(kernel="rmsnorm_bwd", shape=shape, variant="F.rms_norm in turns",
                  ms=times["kernel"], library_ms=times["F.rms_norm"],
                  library_device_us=split, library_device_us_total=sum(split.values()),
                  library_clean_device_us_total=sum(split_us(lib, flush, clean=True).values())))
        del xr, wr, y
        if "cluster" in getattr(ops.bwd_plan, "__wrapped__", ops.bwd_plan).__code__.co_varnames:
            for chunks in BWD_SWEEP["chunks"]:
                for bps in BWD_SWEEP["blocks_per_sm"]:
                    for cl in BWD_SWEEP["cluster"]:
                        over = dict(chunks=chunks, blocks_per_sm=bps, cluster=cl)
                        try:
                            ops.bwd_plan(R, D, 2, n_sm, **over)
                        except ValueError:
                            continue
                        with patched(ops, "bwd_plan", **over):
                            plan = ops.card_bwd_plan(R, D, 2, 0)
                            fn = call(ops)
                            split = split_us(fn, flush)
                            emit(dict(kernel="rmsnorm_bwd", shape=shape, variant="sweep",
                                      plan=plan._asdict(), **check(ops), ms=timed(fn, flush),
                                      device_us_total=sum(split.values()),
                                      clean_device_us_total=sum(
                                          split_us(fn, flush, clean=True).values()),
                                      occupancy=ops.bwd_occupancy(plan, 2, D)))
        del x, dy, w


if __name__ == "__main__":
    sys.exit(main())
