#!/usr/bin/env python3
"""Where kernel 2's mma path (bf16 q, ``paged_attention_mma``) spends its
time on one NVIDIA card, at the paged serving shape of chip_smoke phase
4 (qwen2.5-7b: 4 slots of 2100, 2081, 2117, 2064 live tokens, page 16,
Hq 28, Hkv 4, hd 128), bf16 and int8 KV.

    PYTHONPATH=src python3 scripts/paged_attention_probe.py [--parent DIR]

It builds the kernel's source as it is and ablated copies of it (each a
textual edit of ``csrc/paged_decode_attention.cu``, built into
``build/probe/``).  For each, over a sweep of splits per (slot, KV
head), it prints the CUDA-event time with L2 flushed before each run (as
chip_smoke times it), the same with the pools left in L2 from the run
before, the profiler's device time per call (the kernel alone, without
its launch), and the blocks an SM holds at once.  The ablations give
wrong outputs and are timed only:

- ``no_merge``: no block adds the partials (the ticket is still taken);
- ``no_ticket``: each block writes its partial and ends (no ticket);
- ``no_math``: no warp computes (the tiles are still brought in);
- ``no_copy``: no token row is read (every copy zero-fills, and the
  block table is not read).

The kernel is also timed after an L2 flush by a read of 256 MB (the
usual flush writes them, leaving L2 full of dirty lines that the
kernel's reads must write back), with each slot's pages in address
order (the serving shape's block table is a shuffle), and on the same
bytes laid out as 16 slots of one KV head each (each head's token rows
then lie contiguous); ``torch.sum`` over the K and V pools (all pages, a
little more than the live bytes) gives the rate a plain read reaches.
A further copy stamps %globaltimer in thread 0 of every block at each
phase boundary of one call (L2 flushed): entry, lengths read, the first
tiles' copies issued, first tile in, tiles done, partial written,
ticket taken, merged; it prints the median and the last block's time of
each since the first entry.

``--parent DIR`` (repeatable) also times the kernel of another checkout
(``DIR/src/repro_torch/csrc/paged_decode_attention.cu``) through the
wrapper of that checkout, in turns with this one.  Writes everything to
``chiprun_out/paged_attention_probe.json``.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from int4_gemv_probe import timed  # noqa: E402  (this script's folder)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_decode_attention import ops, ref  # noqa: E402
from repro_torch.quant.kv import quantize_kv_write  # noqa: E402

OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "probe"
LENGTHS = (2100, 2081, 2117, 2064)
PAGE, SPAN, HQ, HKV, HD = 16, 2176, 28, 4, 128
SRC = ROOT / "src" / "repro_torch" / "csrc" / "paged_decode_attention.cu"
ABLATIONS = {   # name: the edits, each (old, new), made to the source
    "no_merge": [("  if (!last_s) return;", "  if (last_s || !last_s) return;")],
    "no_ticket": [("    if (n_split == 1) return;", "    return;")],
    "no_math": [("        if (s0 + u0 < s1) {", "        if (s0 + u0 < 0) {")],
    "no_copy": [("if (k < count && first + k < n_tiles && t < s1)", "if (false)")],
}


# The timeline copy: thread 0 of each block stamps %globaltimer (ns) at
# each of these points, into a device array read back after one call.
STAMPS = [
    ("entry", "  const int gr = lane / 4, tq = lane % 4;   // fragment row group, lane in quad\n", True),
    ("length read", "  const bool live = s0 < s1;\n", True),
    ("tiles issued", "      issue(0, kStages);\n", True),
    ("first tile in", "        __syncthreads();   // the tile (and q) has arrived\n", True),
    ("tiles done", "    cp_wait<0>();\n    __syncthreads();   // the ring is free", False),
    ("partial written", "  // the ticket: release this block's partial", False),
    ("ticket taken", "  if (!last_s) return;", False),
    ("merged", "  if (tid == 0) tickets[pair] = 0;", False),
]
TIMELINE_HEAD = r"""
__device__ unsigned long long probe_ts[1 << 16];
#define STAMP(k) do { if (threadIdx.x == 0) { unsigned long long t_;                    \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                               \
    probe_ts[(((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) << 3) + (k)] = t_; } } while (0)
"""
TIMELINE_TAIL = r"""
extern "C" int probe_ts_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, probe_ts, n * sizeof(unsigned long long));
}
extern "C" int probe_ts_clear() {
  static unsigned long long zero[1 << 16];
  return (int)cudaMemcpyToSymbol(probe_ts, zero, sizeof(zero));
}
"""


def timeline_source(text: str, stamps=STAMPS, first="tile == 0") -> str:
    """The kernel's source with a STAMP(k) at each point of ``stamps``
    (after the anchor when the flag is set, else before it); the point
    "first tile in" is stamped only where ``first`` holds."""
    for k, (name, anchor, after) in enumerate(stamps):
        if text.count(anchor) != 1:
            raise SystemExit(f"timeline anchor {anchor!r} is not in the source once")
        stamp = f"  if ({first}) STAMP({k});\n" if name == "first tile in" else f"  STAMP({k});\n"
        text = text.replace(anchor, anchor + stamp if after else stamp + anchor)
    head = text.index("namespace {")
    return text[:head] + TIMELINE_HEAD + text[head:] + TIMELINE_TAIL


def timeline(lib, run, flush, n_blocks: int, stamps=STAMPS) -> dict:
    """One call after warm-up with L2 flushed: per point, the median and
    the largest time (us) since the first block's entry, over blocks."""
    import numpy as np
    run()
    lib.probe_ts_clear()
    flush.zero_()
    torch.cuda._sleep(2_000_000)
    run()
    torch.cuda.synchronize()
    buf = np.zeros(n_blocks * 8, dtype=np.uint64)
    _build.check(lib.probe_ts_read(buf.ctypes.data, buf.size), "probe_ts_read")
    ts = buf.reshape(n_blocks, 8).astype(np.float64)
    t0 = ts[:, 0].min()
    out = {}
    for k, (name, _, _) in enumerate(stamps):
        hit = ts[:, k] > 0
        if hit.any():
            rel = (ts[hit, k] - t0) / 1e3
            out[name] = dict(blocks=int(hit.sum()), median_us=float(np.median(rel)),
                             max_us=float(rel.max()))
    return out


def compile_copy(text: str, name: str, kernel: str) -> ctypes.CDLL:
    """Build ``text`` (a copy of a source in csrc/, whose headers it
    includes) into ``build/probe/<name>.so`` and load it; prints ptxas'
    registers and spills of ``kernel``'s instances."""
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    src.write_text(text)
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(src)], check=True, capture_output=True, text=True)
    entry = None
    for line in (done.stdout + done.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and ("registers" in line or "spill" in line):
            print(f"{name} {entry[:60]}: {line.split(':', 1)[-1].strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def build(text: str, name: str) -> ctypes.CDLL:
    cdll = compile_copy(text, name, "paged_attention_mma")
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.paged_decode_attention_mma_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    cdll.paged_decode_attention_mma_blocks_per_sm.argtypes = [i, i]
    return cdll


def timed_clean(fn, flush, iters=30) -> float:
    """As ``timed``, with L2 flushed by reading 256 MB instead of writing
    them: no dirty line is left to be written back while fn runs."""
    for _ in range(5):
        fn()
    events = []
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_us(fn, flush, iters=20, match="paged_") -> float:
    """torch.profiler device time per call (us) of the kernels whose name
    holds ``match`` (kernel 2's by default), L2 flushed before each call:
    the kernels alone, without the launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if match in e.key and "fill" not in e.key) / iters


def case(dev, quant: bool, seed: int = 99, lengths=LENGTHS, hq=HQ, hkv=HKV):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, max_blocks = len(lengths), SPAN // PAGE
    n_pages = 1 + B * max_blocks
    q = (2 * torch.randn((B, hq, HD), generator=g, device=dev)).bfloat16()
    shape = (n_pages, PAGE, hkv, HD)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    if quant:
        (k, ks), (v, vs) = quantize_kv_write(k), quantize_kv_write(v)
    else:
        k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = torch.arange(max_blocks, device=dev)[None] * PAGE < lens[:, None]
    bt = torch.where(live, perm.reshape(B, max_blocks), 0).to(torch.int32).contiguous()
    return q, k, v, bt, lens, ks, vs


def launcher(lib, args, n_split: int):
    q, k, v, bt, lens, ks, vs = args
    B, max_blocks = bt.shape
    hkv = k.shape[2]
    G = q.shape[1] // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, hkv, n_split, G, HD), **f32)
    part_ml = torch.empty((B, hkv, n_split, 2, G), **f32)
    tickets = torch.zeros(B * hkv, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    quant = ks is not None

    def run():
        rc = lib.paged_decode_attention_mma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
            bt.data_ptr(), lens.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), B, max_blocks, PAGE, hkv, G, HD,
            n_split, int(quant), torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "probe launch")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    ap.add_argument("--splits", default="8,16")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    text = SRC.read_text()
    libs = {"kernel": build(text, "kernel")}
    for name, edits in ABLATIONS.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"ablation {name}: {old!r} is not in the source")
            edited = edited.replace(old, new)
        libs[name] = build(edited, name)
    stamped = build(timeline_source(text), "timeline")
    stamped.probe_ts_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"device": smi, "rows": []}
    for quant in (False, True):
        kv = "int8" if quant else "bf16"
        plan = ops.mma_split_plan(len(LENGTHS), HKV, SPAN, n_sm, quant)
        args = case(dev, quant)
        want = (ref.paged_decode_attention_quant_ref(args[0], args[1], args[2], args[5],
                                                     args[6], args[3], args[4])
                if quant else ref.paged_decode_attention_ref(*args[:5])).float()
        for name, lib in libs.items():
            occ = lib.paged_decode_attention_mma_blocks_per_sm(HD, int(quant))
            for n_split in map(int, a.splits.split(",")):
                run = launcher(lib, args, n_split)
                err = float((run().float() - want).abs().max())
                cold = timed(run, flush)
                warm = timed(run, flush, flush_l2=False)
                row = dict(kv=kv, variant=name, n_split=n_split, blocks_per_sm=occ,
                           blocks=n_split * len(LENGTHS) * HKV, ms=cold, warm_ms=warm,
                           device_us=device_us(run, flush), max_abs_err=err)
                result["rows"].append(row)
                print(json.dumps(row), flush=True)
        # the same call with each slot's pages in address order
        seq = list(args)
        B, max_blocks = args[3].shape
        order = torch.arange(1, 1 + B * max_blocks, device=dev, dtype=torch.int32)
        seq[3] = torch.where(args[3] > 0, order.reshape(B, max_blocks), 0).to(torch.int32)
        run = launcher(libs["kernel"], seq, plan)
        row = dict(kv=kv, variant="pages in address order", n_split=plan,
                   ms=timed(run, flush), device_us=device_us(run, flush))
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
        # the same call after an L2 flush that leaves no dirty line
        run = launcher(libs["kernel"], args, plan)
        row = dict(kv=kv, variant="L2 flushed by a read", n_split=plan,
                   ms=timed_clean(run, flush), dirty_flush_ms=timed(run, flush))
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
        # a plain read of the same pools: what this card reaches on them
        k, v = args[1], args[2]
        read = lambda: (k.view(torch.float32).sum(), v.view(torch.float32).sum())  # noqa: E731
        row = dict(kv=kv, variant="torch.sum of the K and V pools",
                   bytes=2 * k.numel() * k.element_size(), ms=timed(read, flush),
                   device_us=device_us(read, flush, match="educe"))
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
        # the same bytes with one KV head a slot (16 slots, G 7): each
        # head's token rows lie contiguous in its pages
        one = case(dev, quant, lengths=LENGTHS * 4, hq=HQ // HKV, hkv=1)
        run = launcher(libs["kernel"], one, plan)
        row = dict(kv=kv, variant="16 slots x 1 KV head (same bytes)", n_split=plan,
                   ms=timed(run, flush), device_us=device_us(run, flush))
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
        n_blocks = plan * len(LENGTHS) * HKV
        tl = timeline(stamped, launcher(stamped, args, plan), flush, n_blocks)
        result["rows"].append(dict(kv=kv, variant="timeline", n_split=plan, points=tl))
        for point, v in tl.items():
            print(f"{kv} timeline n_split={plan}: {point:16s} blocks {v['blocks']:4d} "
                  f"median {v['median_us']:7.2f} us, last {v['max_us']:7.2f} us", flush=True)
        for parent in a.parent:
            sys.path[:0] = [str(parent / "src")]
            for m in [m for m in sys.modules if m.startswith("repro_torch")]:
                del sys.modules[m]
            old_ops = importlib.import_module(
                "repro_torch.kernels.paged_decode_attention.ops")
            sys.path.pop(0)
            mine = launcher(libs["kernel"], args, plan)
            times = {"parent": [], "kernel": []}
            dev_us = {}
            for who in ("parent", "kernel", "kernel", "parent"):
                fn = (lambda: old_ops.paged_decode_attention(*args)) if who == "parent" else mine
                times[who].append(timed(fn, flush))
                dev_us[who] = device_us(fn, flush)
            row = dict(kv=kv, variant=f"{parent} vs kernel, in turns", n_split=plan,
                       parent_ms=times["parent"], ms=times["kernel"],
                       parent_device_us=dev_us["parent"], device_us=dev_us["kernel"])
            result["rows"].append(row)
            print(json.dumps(row), flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "paged_attention_probe.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
