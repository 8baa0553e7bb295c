#!/usr/bin/env python3
"""Where kernel 1's mma path (bf16 q, ``decode_attention_mma``) spends its
time on one NVIDIA card, at the two shapes the batch-1 main paths give
it: qwen2.5-7b (Hq 28, Hkv 4, hd 128) and zamba2-1.2b's shared attention
block (Hq 32, Hkv 32, hd 64), both at the first decode step of chip_smoke
phases 10 and 14 (S 2081, slots 0..2048 valid).

    PYTHONPATH=src python3 scripts/decode_attention_probe.py [--parent DIR]

It builds the kernel's source as it is and ablated copies of it (each a
textual edit of ``csrc/decode_attention.cu``, built into
``build/probe/``).  For each, over a sweep of splits per (b, KV head), it
prints the CUDA-event time with L2 flushed before each run (as
chip_smoke times it), the same with K/V left in L2 from the run before,
and the profiler's device time per call (the kernel alone, without its
launch).  The ablations give wrong outputs and are timed only:

- ``no_merge``: no block adds the partials (the ticket is still taken);
- ``no_ticket``: each block writes its partial and ends (no ticket);
- ``no_math``: no warp computes (the tiles are still brought in);
- ``no_copy``: no K/V row is read (every copy zero-fills);
- ``stages5`` (right outputs): a 5-slot ring in place of 3.

At the split plan's n_split it also prints the wrapper's host time per
call (200 calls, not synchronised), ``F.scaled_dot_product_attention``
on the same inputs (timed only), a one-element ``add_`` (what the timer
gives a kernel that does nothing), and a %globaltimer timeline of one call
(L2 flushed) from a copy that stamps thread 0 of every block at each
phase boundary: entry, mask read, the first tiles' copies issued, first
tile in, tiles done, partial written, ticket taken, merged (median and
last block, us since the first entry).

``--parent DIR`` (repeatable) also times the kernel of another checkout
through that checkout's wrapper, in turns with this one (parent, kernel,
kernel, parent), with the profiler's device time and the wrapper's host
time of each.  Writes everything to ``chiprun_out/decode_attention_probe.json``.
Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from int4_gemv_probe import timed  # noqa: E402  (this script's folder)
from paged_attention_probe import compile_copy, device_us, timeline, timeline_source  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402

OUT = ROOT / "chiprun_out"
S, VALID = 2081, 2049          # cache slots, valid slots at the first decode step
SHAPES = {"qwen2.5-7b": (28, 4, 128), "zamba2-1.2b": (32, 32, 64)}   # Hq, Hkv, hd
SWEEP = {"qwen2.5-7b": (11, 16, 22, 33, 44), "zamba2-1.2b": (2, 4, 8)}
SRC = ROOT / "src" / "repro_torch" / "csrc" / "decode_attention.cu"
KERNEL = "decode_attention_mma"
ABLATIONS = {   # name: the edits, each (old, new), made to the source
    "no_merge": [("  if (!last_s) return;", "  if (last_s || !last_s) return;")],
    "no_ticket": [("    if (n_split == 1) return;", "    return;")],
    "no_math": [("        if (ubits) {", "        if (ubits & 0u) {")],
    "no_copy": [("const bool ok = (bits_s[t / 32] >> (t % 32)) & 1u;", "const bool ok = false;")],
    # right outputs: a 5-slot ring
    "stages5": [("constexpr int kStages = 3;", "constexpr int kStages = 5;")],
}
STAMPS = [   # (point, anchor, stamp after the anchor)
    ("entry", "  const int pair = b * Hkv + h;\n", True),
    ("mask read", "      // tiles with a valid slot, as a 64-bit set (every warp finds it)\n", False),
    ("tiles issued", "      for (int j = 0; j < kStages; ++j) issue(j);\n", True),
    ("first tile in", "        __syncthreads();   // the tile (and q) has arrived\n", True),
    ("tiles done", "    cp_wait<0>();\n    __syncthreads();   // the ring is free", False),
    ("partial written", "  // the ticket: release this block's partial", False),
    ("ticket taken", "  if (!last_s) return;", False),
    ("merged", "  if (tid == 0) tickets[pair] = 0;", False),
]


def build(text: str, name: str) -> ctypes.CDLL:
    cdll = compile_copy(text, name, KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.decode_attention_mma_launch.argtypes = [
        p, p, p, p, ctypes.c_longlong, p, p, p, p, i, i, i, i, i, i, p]
    cdll.decode_attention_mma_blocks_per_sm.argtypes = [i]
    return cdll


def case(dev, hq: int, hkv: int, hd: int, seed: int = 99):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (2 * torch.randn((1, hq, hd), generator=g, device=dev)).bfloat16()
    k = torch.randn((1, S, hkv, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((1, S, hkv, hd), generator=g, device=dev).bfloat16()
    return q, k, v, torch.arange(S, device=dev) < VALID


def launcher(lib, args, n_split: int):
    """A call of ``lib``'s mma kernel with n_split splits on scratch of
    its own (tickets zeroed once; every launch leaves them at 0)."""
    q, k, v, mask = args
    B, hq, hd = q.shape
    hkv = k.shape[2]
    G = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, hkv, n_split, G, hd), **f32)
    part_ml = torch.empty((B, hkv, n_split, 2, G), **f32)
    tickets = torch.zeros(B * hkv, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)

    def run():
        rc = lib.decode_attention_mma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), 0,
            part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            B, S, hkv, G, hd, n_split, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "probe launch")
        return out
    return run


def host_us(fn, n: int = 200) -> float:
    """The wrapper's host time per call: n calls between host clocks,
    not synchronised (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def parent_ops(parent: Path):
    """Kernel 1's wrapper module of the checkout at ``parent``."""
    sys.path[:0] = [str(parent / "src")]
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m.startswith("repro_torch")}
    try:
        return importlib.import_module("repro_torch.kernels.decode_attention.ops")
    finally:
        sys.path.pop(0)
        for m in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[m]
        sys.modules.update(saved)


def main() -> int:
    import torch.nn.functional as F
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout to time beside (repeatable)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    text = SRC.read_text()
    libs = {"kernel": build(text, "da_kernel")}
    for name, edits in ABLATIONS.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"ablation {name}: {old!r} is not in the source")
            edited = edited.replace(old, new)
        libs[name] = build(edited, f"da_{name}")
    stamped = build(timeline_source(text, STAMPS, "j == 0 && w0 == s0"), "da_timeline")
    stamped.probe_ts_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    parents = {str(p): parent_ops(p) for p in a.parent}
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"device": smi, "rows": []}

    def emit(row):
        result["rows"].append(row)
        print(json.dumps(row), flush=True)

    for shape, (hq, hkv, hd) in SHAPES.items():
        args = case(dev, hq, hkv, hd)
        q, k, v, mask = args
        want = ref.decode_attention_ref(*args).float()
        plan = ops.mma_split_plan(1, hkv, S, n_sm)
        for name, lib in libs.items():
            occ = lib.decode_attention_mma_blocks_per_sm(hd)
            for n_split in SWEEP[shape] if name == "kernel" else (plan,):
                run = launcher(lib, args, n_split)
                err = float((run().float() - want).abs().max())
                emit(dict(shape=shape, variant=name, n_split=n_split, blocks_per_sm=occ,
                          blocks=n_split * hkv, ms=timed(run, flush),
                          warm_ms=timed(run, flush, flush_l2=False),
                          device_us=device_us(run, flush, match=KERNEL), max_abs_err=err))
        wrapper = lambda: ops.decode_attention(*args)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask.reshape(1, 1, 1, S), enable_gqa=True)
        emit(dict(shape=shape, variant="wrapper", n_split=plan, path=ops.path_for(q, k),
                  ms=timed(wrapper, flush), host_us=host_us(wrapper),
                  max_abs_err=float((wrapper().float() - want).abs().max())))
        emit(dict(shape=shape, variant="F.scaled_dot_product_attention", ms=timed(sdpa, flush)))
        one = torch.zeros(1, device=dev)
        emit(dict(shape=shape, variant="one-element add_ (the timer's floor)",
                  ms=timed(lambda: one.add_(1), flush)))
        tl = timeline(stamped, launcher(stamped, args, plan), flush, plan * hkv, STAMPS)
        result["rows"].append(dict(shape=shape, variant="timeline", n_split=plan, points=tl))
        for point, t in tl.items():
            print(f"{shape} timeline n_split={plan}: {point:16s} blocks {t['blocks']:4d} "
                  f"median {t['median_us']:7.2f} us, last {t['max_us']:7.2f} us", flush=True)
        for parent, old_ops in parents.items():
            calls = {"parent": lambda: old_ops.decode_attention(*args), "kernel": wrapper}
            times = {"parent": [], "kernel": []}
            for who in ("parent", "kernel", "kernel", "parent"):
                times[who].append(timed(calls[who], flush))
            emit(dict(shape=shape, variant=f"{parent} vs kernel, in turns", n_split=plan,
                      parent_ms=times["parent"], ms=times["kernel"],
                      parent_device_us=device_us(calls["parent"], flush, match="decode_attention"),
                      device_us=device_us(wrapper, flush, match="decode_attention"),
                      parent_host_us=host_us(calls["parent"]), host_us=host_us(wrapper)))
        del args, q, k, v, mask
    OUT.mkdir(exist_ok=True)
    (OUT / "decode_attention_probe.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
