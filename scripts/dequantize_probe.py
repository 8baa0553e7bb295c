#!/usr/bin/env python3
"""Where the dequantisation kernel (``csrc/dequantize.cu``) spends its time
on one NVIDIA card, at the shapes the main paths give it: a
qwen2-moe-a2.7b expert stack (60, 2048, 1408) int4 and qwen2.5-7b's
w_gate (3584, 18944) int4 and int8, group 128, to bf16.

    PYTHONPATH=src python3 scripts/dequantize_probe.py

For each shape it prints, with int4_gemv_probe's timer (CUDA-event median
of 30 runs after 5 warm-ups, 256 MB written before each run):

- each variant of the source, its time and realised GB/s against the
  bound (code + scale + output bytes at 3.35 TB/s), and whether its
  output is bit-equal to the plain version (``ref.py``);
- the card's own rates on the same bytes: ``fill_`` of the output
  (writes only) and a bf16 ``copy_`` of it (as many bytes read as
  written).

Variants are copies of the source with textual edits, built into
``build/probe/`` with the source's flags:

- ``as_built``: the source;
- ``grid_stride``: 4 blocks an SM (132 SMs), each thread looping over
  items;
- ``stream_stores``: the output stored with ``__stcs`` (evict first);
- ``no_store`` (an ablation, wrong output): the stores behind a guard no
  run meets, so the time is the reads' and the index math's.

Writes ``chiprun_out/dequantize_probe.json``.  Needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from int4_gemv_probe import timed  # noqa: E402  (this script's folder)
from paged_attention_probe import compile_copy  # noqa: E402
from repro_torch.kernels.dequantize import ops, ref  # noqa: E402

HBM_BPS = 3.35e12
SHAPES = (("qwen2-moe-a2.7b w_gate stack", 4, (60,), 2048, 1408),
          ("qwen2.5-7b w_gate", 4, (), 3584, 18944),
          ("qwen2.5-7b w_gate", 8, (), 3584, 18944))
STORE = "      *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(o);"
STREAM = "      __stcs(reinterpret_cast<uint4*>(orow), *reinterpret_cast<const uint4*>(o));"
NO_STORE = ("      if (n < 0) *reinterpret_cast<uint4*>(orow) = "
            "*reinterpret_cast<const uint4*>(o);")
# grid_stride: 4 blocks an SM (132 SMs), each thread looping over items
GRID_EDITS = (
    ("  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n"
     "  if (t >= n_items) return;\n",
     "  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n"
     "       t < n_items; t += static_cast<long long>(gridDim.x) * kThreads) {\n"),
    ("\n}\n\ntemplate <typename T, int BITS>\ncudaError_t launch_typed",
     "\n  }\n}\n\ntemplate <typename T, int BITS>\ncudaError_t launch_typed"),
    ("  const long long blocks = (n_items + kThreads - 1) / kThreads;",
     "  const long long want = (n_items + kThreads - 1) / kThreads;\n"
     "  const long long blocks = want < 132 * 4 ? want : 132 * 4;"))


def edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def variants(text: str) -> dict:
    return {"as_built": text, "grid_stride": edit(text, GRID_EDITS),
            "stream_stores": edit(text, ((STORE, STREAM),)),
            "no_store": edit(text, ((STORE, NO_STORE),))}


def build(text: str, name: str) -> ctypes.CDLL:
    cdll = compile_copy(text, name, "dequantize_kernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.dequantize_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, i, p]
    cdll.dequantize_launch.restype = i
    return cdll


def case(dev, bits, lead, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = K // 2 if bits == 4 else K
    codes = torch.randint(0, 256, lead + (rows, N), generator=g, device=dev,
                          dtype=torch.int32)
    codes = codes.to(torch.uint8) if bits == 4 else (codes - 128).to(torch.int8)
    scales = torch.rand(lead + (K // 128, N), generator=g, device=dev) * 0.01 + 1e-3
    return codes, scales


def main() -> int:
    if not torch.cuda.is_available():
        print("dequantize_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "dequantize.cu").read_text()
    libs = {name: build(src, f"dequantize_{name}") for name, src in variants(text).items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"card": smi, "shapes": []}
    for label, bits, lead, K, N in SHAPES:
        codes, scales = case(dev, bits, lead, K, N)
        want = ref.dequantize_ref(codes, scales, bits, torch.bfloat16)
        got = torch.empty_like(want)
        nbytes = (codes.numel() * codes.element_size() + scales.numel() * 4
                  + want.numel() * 2)
        bound = nbytes / HBM_BPS * 1e3
        rec = {"shape": label, "bits": bits, "dims": list(want.shape), "bytes": nbytes,
               "bound_ms": bound, "runs": []}
        print(f"{label} {tuple(want.shape)} int{bits} -> bf16: {nbytes} bytes, bound "
              f"{bound:.4f} ms", flush=True)
        code_rows = codes.numel() // N
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.dequantize_launch(codes.data_ptr(), scales.data_ptr(),
                                           got.data_ptr(), code_rows, N, bits, 128, 1, 1,
                                           stream)
                assert rc == 0, rc
            got.zero_()
            call()
            torch.cuda.synchronize()
            equal = bool(torch.equal(got.view(torch.int16), want.view(torch.int16)))
            ms = timed(call, flush)
            rec["runs"].append({"variant": name, "ms": ms, "gbps": nbytes / ms / 1e6,
                                "of_bound": bound / ms, "bit_equal": equal})
            print(f"  {name:14s}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
                  f"{bound / ms:.1%} of the bound, bit-equal {equal}", flush=True)
        wrapper_ms = timed(lambda: ops.dequantize(codes, scales, bits, torch.bfloat16), flush)
        fill_ms = timed(lambda: got.fill_(1.0), flush)
        src = torch.empty_like(want)
        copy_ms = timed(lambda: got.copy_(src), flush)
        rec.update(wrapper_ms=wrapper_ms, fill_ms=fill_ms,
                   fill_gbps=want.numel() * 2 / fill_ms / 1e6, copy_ms=copy_ms,
                   copy_gbps=want.numel() * 4 / copy_ms / 1e6)
        print(f"  the wrapper: {wrapper_ms:.4f} ms; the "
              f"card on the output's bytes: fill_ {fill_ms:.4f} ms "
              f"({rec['fill_gbps']:.1f} GB/s), bf16 copy_ {copy_ms:.4f} ms "
              f"({rec['copy_gbps']:.1f} GB/s)", flush=True)
        out["shapes"].append(rec)
        del codes, scales, want, got, src
    dest = ROOT / "chiprun_out" / "dequantize_probe.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
