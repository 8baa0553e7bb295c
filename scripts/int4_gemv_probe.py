#!/usr/bin/env python3
"""Where kernel 3's GEMV (M <= 4) spends its time on one NVIDIA card.

    PYTHONPATH=src python3 scripts/int4_gemv_probe.py [--parent DIR]

For each qwen2.5-7b layer shape at M=1 and M=4 (bf16 x, group 128) it
prints the GEMV's CUDA-event time with L2 flushed before each run (as
chip_smoke times it), the same with the weights left in L2 from the run
before (if that is no faster, the loads are not what bounds it), and the
profiler's device time per kernel, with ``torch.sum`` over a buffer of
the same bytes beside them.  For the gate shape's packed bytes (36 MB)
it also times three bare streaming reads built here: in address order,
in the GEMV's 128-column tiles with each thread row reading one run of
rows, and in the tiles read band by band as the GEMV reads them.

``--parent DIR`` also builds ``DIR/src/repro_torch/csrc/int4_matmul.cu``
from another checkout of the repository (``git archive`` of an earlier
commit, unpacked) and times its GEMV beside this one; its launcher must
be the split-K one of PR 15 (``splits``, ``k_split`` and a separate
reduce kernel), whose split plan is copied below.

Writes everything to ``chiprun_out/int4_gemv_probe.json``.  Needs the
CUDA toolkit (nvcc) and a card; builds into ``build/probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.int4_matmul import ops, ref  # noqa: E402

LAYER = [("wq", 3584, 3584), ("wk", 3584, 512), ("wv", 3584, 512),
         ("wo", 3584, 3584), ("gate", 3584, 18944), ("up", 3584, 18944),
         ("down", 18944, 3584)]
OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "probe"

READS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint4 ld(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ void keep(unsigned a, unsigned* out) {
  if (a == 0x9E3779B9u) out[0] = a;  // never true for the probe's data
}
// address order: grid-stride over 16-byte chunks, 8 in flight per thread
__global__ void read_linear(const uint8_t* p, long long n16, unsigned* out) {
  unsigned a = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n16; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = i + u * stride < n16 ? ld(p + 16 * (i + u * stride)) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) a ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  keep(a, out);
}
// (rows, N) bytes in 128-column tiles, one block per tile; thread row rl
// (8 lanes of 16 bytes) reads rows [rl run, rl run + run), 8 at a time
__global__ void read_runs(const uint8_t* p, int rows, int N, unsigned* out) {
  const int cl = threadIdx.x % 8, rl = threadIdx.x / 8;
  const int run = (rows + 31) / 32, r0 = rl * run, r1 = min(rows, r0 + run);
  const uint8_t* src = p + blockIdx.x * 128 + cl * 16;
  unsigned a = 0;
  for (int r = r0; r < r1; r += 8) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = r + u < r1 ? ld(src + (size_t)(r + u) * N) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) a ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  keep(a, out);
}
// the same tiles read in bands of 256 rows: thread row rl reads rows
// rl 8 .. rl 8 + 7 of each band, the next band's loads issued first
__global__ void read_bands(const uint8_t* p, int rows, int N, unsigned* out) {
  const int cl = threadIdx.x % 8, rl = threadIdx.x / 8;
  const uint8_t* src = p + blockIdx.x * 128 + cl * 16;
  unsigned a = 0;
  uint4 va[8], vb[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) va[u] = rl * 8 + u < rows ? ld(src + (size_t)(rl * 8 + u) * N) : make_uint4(0, 0, 0, 0);
  for (int r = rl * 8; r < rows; r += 512) {
#pragma unroll
    for (int u = 0; u < 8; ++u) vb[u] = r + 256 + u < rows ? ld(src + (size_t)(r + 256 + u) * N) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) a ^= va[u].x ^ va[u].y ^ va[u].z ^ va[u].w;
#pragma unroll
    for (int u = 0; u < 8; ++u) va[u] = r + 512 + u < rows ? ld(src + (size_t)(r + 512 + u) * N) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) a ^= vb[u].x ^ vb[u].y ^ vb[u].z ^ vb[u].w;
  }
  keep(a, out);
}
extern "C" int probe_read(int kind, const void* p, int rows, int N, void* out, void* st) {
  cudaStream_t s = (cudaStream_t)st;
  const uint8_t* b = (const uint8_t*)p;
  if (kind == 0) read_linear<<<1056, 256, 0, s>>>(b, (long long)rows * N / 16, (unsigned*)out);
  if (kind == 1) read_runs<<<N / 128, 256, 0, s>>>(b, rows, N, (unsigned*)out);
  if (kind == 2) read_bands<<<N / 128, 256, 0, s>>>(b, rows, N, (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def build(src: Path, name: str) -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / f"{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def timed(fn, flush, iters=30, flush_l2=True) -> float:
    """CUDA-event median (ms) of iters runs after 5 warm-ups; with
    flush_l2, 256 MB are written before each run, else the data stays in
    L2 from the run before."""
    for _ in range(5):
        fn()
    events = []
    for _ in range(iters):
        if flush_l2:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_us(fn, flush, iters=20) -> dict:
    """torch.profiler device time per call (us), by kernel (the GEMV, the
    split-K reduce, the probe's reads)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        name = re.search(r"(int4_\w+|read_\w+)", e.key)
        if name:
            found[name.group(1)] = found.get(name.group(1), 0.0) + e.self_device_time_total / iters
    return found


def parent_plan(K: int, N: int, n_sm: int):
    """PR 15's split plan for its GEMV (256-column blocks, K slices of a
    multiple of 16 rows, about two blocks per SM)."""
    col_blocks = math.ceil(N / 256)
    splits = max(1, min(math.ceil(K / 16), round(2 * n_sm / col_blocks)))
    k_split = 16 * math.ceil(K / splits / 16)
    return math.ceil(K / k_split), k_split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int4_gemv_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    parent = None
    if args.parent:
        parent = build(args.parent / "src/repro_torch/csrc/int4_matmul.cu", "parent")
        p, i = ctypes.c_void_p, ctypes.c_int
        parent.int4_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        parent.int4_matmul_launch.restype = i
    result = {"card": smi, "shapes": [], "reads": {}}
    for M in (1, 4):
        for name, K, N in LAYER:
            g = torch.Generator(device=dev).manual_seed(K + N + M)
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            packed = torch.randint(0, 256, (K // 2, N), generator=g, device=dev, dtype=torch.uint8)
            scales = 0.005 + 0.01 * torch.rand((K // 128, N), generator=g, device=dev)
            want = ref.int4_matmul_ref(x, packed, scales, 128).float()

            def gemv():
                return ops.int4_matmul(x, packed, scales, group=128)
            err = float((gemv().float() - want).abs().max())
            buf = torch.empty(packed.numel() + scales.numel() * 4, dtype=torch.uint8,
                              device=dev).view(torch.float32)
            row = dict(name=name, M=M, K=K, N=N, splits=ops.split_plan(K, N, n_sm, M),
                       max_abs_err=err, ms=timed(gemv, flush),
                       ms_in_l2=timed(gemv, flush, flush_l2=False),
                       device_us=device_us(gemv, flush),
                       read_ms=timed(lambda: torch.sum(buf), flush))
            if parent is not None:
                splits, k_split = parent_plan(K, N, n_sm)
                part = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
                out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)

                def old():
                    rc = parent.int4_matmul_launch(
                        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), part.data_ptr(),
                        out.data_ptr(), M, K, N, 128, splits, k_split, 1, stream())
                    assert rc == 0, rc
                old()
                torch.cuda.synchronize()
                row["parent"] = dict(splits=splits, k_split=k_split,
                                     max_abs_err=float((out.float() - want).abs().max()),
                                     ms=timed(old, flush), ms_in_l2=timed(old, flush, flush_l2=False),
                                     device_us=device_us(old, flush))
            print(json.dumps(row), flush=True)
            result["shapes"].append(row)
            del x, packed, scales, buf, want
    src = BUILD / "reads.cu"
    BUILD.mkdir(parents=True, exist_ok=True)
    src.write_text(READS)
    reads = build(src, "reads")
    p, i = ctypes.c_void_p, ctypes.c_int
    reads.probe_read.argtypes = [i, p, i, i, p, p]
    reads.probe_read.restype = i
    K, N = 3584, 18944
    data = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, device=dev)
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    for kind, label in enumerate(("address order", "one run of rows per thread row",
                                  "bands, as the GEMV reads them")):
        fn = lambda: reads.probe_read(kind, data.data_ptr(), K // 2, N, sink.data_ptr(), stream())  # noqa: E731
        result["reads"][label] = dict(ms=timed(fn, flush),
                                      device_us=sum(device_us(fn, flush).values()))
        print(label, json.dumps(result["reads"][label]), flush=True)
    f = data.view(torch.float32)
    result["reads"]["torch.sum"] = dict(ms=timed(lambda: torch.sum(f), flush))
    print("torch.sum", json.dumps(result["reads"]["torch.sum"]), flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "int4_gemv_probe.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
