#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing catches:

 1. setup: the card's name and power limit, versions, and the build of
    every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per source,
    all started together).
 2. decode-attention kernel against its plain version, bf16 and f32, on
    the qwen2.5-7b decode shape and on ragged, per-sequence-mask (one row
    fully masked), MHA, G=4, G=8 and B=3 shapes; times of the kernel, the
    plain version and ``F.scaled_dot_product_attention`` (timed only).
 3. int4-matmul kernel against its plain version at the qwen2.5-7b layer
    shapes, M=1 and M=2048, with codes that hit -8 and 7; times of the
    kernel, the plain version and ``torch.matmul`` on the bf16
    dequantised weight (timed only).
 4. the kernel inside the real path: a qwen2.5-7b-width model with 2
    layers in f32; greedy tokens of ``decode_backend="cuda"`` and
    ``"sdpa"`` must be identical over 16 tokens.
 5. the main path at full width: qwen2.5-7b, 28 layers, bf16, random
    weights drawn on the card; three requests of 2048 prompt tokens
    through ``DecodeEngine`` (two ``generate_streamed``, one
    ``generate_fused``, 32 new tokens each); the decode-attention launch
    count must be 28 x decode steps; first-step logits of "cuda" and
    "sdpa" must agree; p50 step time against the analytic floor.
 6. the int4 main path: the same model quantised on the card
    (``int4_fused``), one request; the int4 launch count must be 7 x 28
    per decode step plus the prefill's.
 7. the kernels line: one JSON object with every ported kernel's
    numbers, and a line naming the TPU kernels still to port.
 8. last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Times are CUDA-event medians of 30 runs
after 5 warm-ups, with L2 flushed before each run; bounds use the
H100 SXM peaks (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32 off the
tensor cores).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
WARMUP, ITERS = 5, 30
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # relative to max(1, |plain|)

PROMPT, NEW = 2048, 32


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """CUDA-event median of ITERS runs after WARMUP, L2 flushed first.

    Before each timed run the card is kept busy (flush + spin) while the
    host enqueues the run, so host-side launch work does not show up as
    device time."""

    def __init__(self, device):
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn) -> float:
        for _ in range(WARMUP):
            fn()
        events = []
        for _ in range(ITERS):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(out, ref) -> tuple:
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    return err, err / scale


# ---------------------------------------------------------------- phase 1
def setup():
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill stores"
                                       not in line):
                log(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, dev


# ---------------------------------------------------------------- phase 2
def attention_case(dev, dtype, B, Hq, Hkv, hd, S, mask, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = 2 * torch.randn((B, Hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(dtype)
    return q, k, v, mask.to(dev)


def check_decode_attention(dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops, ref
    log("== phase 2: decode attention, kernel vs plain")
    S_main = PROMPT + NEW + 1
    gm = torch.Generator().manual_seed(0)
    ragged = torch.rand((2, 2048), generator=gm) < 0.6
    ragged[1] = False
    cases = [
        ("qwen2.5-7b S=2048", 1, 28, 4, 128, 2048, torch.ones(2048, dtype=torch.bool)),
        ("S=2047 ragged", 1, 28, 4, 128, 2047, torch.ones(2047, dtype=torch.bool)),
        ("(B,S) mask, row 1 fully masked", 2, 28, 4, 128, 2048, ragged),
        ("G=1 (MHA)", 1, 32, 32, 64, 1024, torch.arange(1024) < 700),
        ("G=4 (Hq=32, Hkv=8: llama-3.1-8b / mistral-7b)", 1, 32, 8, 128, 2048,
         torch.ones(2048, dtype=torch.bool)),
        ("G=8 (Hq=16, Hkv=2: qwen2.5-3b)", 1, 16, 2, 128, 2048,
         torch.arange(2048) < 1500),
        ("B=3", 3, 28, 4, 128, 1000,
         torch.arange(1000)[None, :] < torch.tensor([[1000], [517], [1]])),
        ("main path: S=2081, first decode step", 1, 28, 4, 128, S_main,
         torch.arange(S_main) <= PROMPT),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, B, Hq, Hkv, hd, S, mask) in enumerate(cases):
            q, k, v, m = attention_case(dev, dtype, B, Hq, Hkv, hd, S, mask, i)
            out = ops.decode_attention(q, k, v, m)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, m)
            err, rel = rel_err(out, want)
            ok = rel <= TOL[dtype]
            if mask.dim() == 2:
                dead = ~mask.any(dim=1)
                ok = ok and bool(out[dead.to(dev)].eq(0).all())
            log(f"  {str(dtype)[6:]:8s} {label}: B={B} Hq={Hq} Hkv={Hkv} hd={hd} "
                f"S={S}: max_abs_err {err:.3g} (tol {TOL[dtype]:g} x max(1,|plain|)) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"decode_attention {label} {dtype} disagrees")

    # times at the main path's shape (bf16, first decode step)
    label, B, Hq, Hkv, hd, S, mask = cases[-1]
    q, k, v, m = attention_case(dev, torch.bfloat16, B, Hq, Hkv, hd, S, mask, 99)
    out = ops.decode_attention(q, k, v, m)
    err, _ = rel_err(out, ref.decode_attention_ref(q, k, v, m))
    ms = timer(lambda: ops.decode_attention(q, k, v, m))
    plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, m))
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    am = m.reshape(1, 1, 1, S)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am, enable_gqa=True))
    n_valid = int(m.sum()) * B
    nbytes = (q.numel() * 2 + 2 * n_valid * Hkv * hd * 2 + m.numel()
              + out.numel() * 2)
    flops = 4 * B * Hq * (n_valid // B) * hd
    b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
    log(f"  times at {label} (bf16, {n_valid} valid slots): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, F.scaled_dot_product_attention {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.3f} MB)")
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention/decode_attention.py:64",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"bf16 B=1 Hq=28 Hkv=4 hd=128 S={S}, {n_valid} valid")


# ---------------------------------------------------------------- phase 3
LAYER = [("wq", 3584, 3584), ("wk", 3584, 512), ("wv", 3584, 512),
         ("wo", 3584, 3584), ("gate", 3584, 18944), ("up", 3584, 18944),
         ("down", 18944, 3584)]


def int4_case(dev, dtype, M, K, N, seed, group=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    packed = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                           dtype=torch.uint8)   # every nibble, -8..7
    scales = 0.005 + 0.01 * torch.rand((K // group, N), generator=g, device=dev)
    return x, packed, scales


def check_int4_matmul(dev, timer):
    from repro_torch.kernels.int4_matmul import ops, ref
    from repro_torch.quant import QuantizedTensor, dequantize
    log("== phase 3: int4 matmul, kernel vs plain (qwen2.5-7b layer shapes)")
    codes = ref.unpack_int4_ref(int4_case(dev, torch.bfloat16, 1, 256, 64, 0)[1])
    if int(codes.min()) != -8 or int(codes.max()) != 7:
        raise AssertionError("test codes do not reach -8 and 7")
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for M in (1, 2048):
        for dtype in ((torch.bfloat16, torch.float32) if M == 1 else (torch.bfloat16,)):
            for i, (name, K, N) in enumerate(LAYER):
                x, packed, scales = int4_case(dev, dtype, M, K, N, 10 * M + i)
                out = ops.int4_matmul(x, packed, scales, group=128)
                torch.cuda.synchronize()
                want = ref.int4_matmul_ref(x, packed, scales, 128)
                err, rel = rel_err(out, want)
                ok = rel <= TOL[dtype]
                line = (f"  {str(dtype)[6:]:8s} {name:4s} M={M} K={K} N={N}: "
                        f"max_abs_err {err:.3g} (tol {TOL[dtype]:g} x "
                        f"max(1,|plain|)) {'ok' if ok else 'FAIL'}")
                if not ok:
                    log(line)
                    raise AssertionError(f"int4_matmul {name} M={M} {dtype} disagrees")
                if dtype != torch.bfloat16:
                    log(line)
                    continue
                w = dequantize(QuantizedTensor(packed, scales, 4, "fused"),
                               torch.bfloat16)
                ms = timer(lambda: ops.int4_matmul(x, packed, scales, group=128))
                plain_ms = timer(lambda: ref.int4_matmul_ref(x, packed, scales, 128))
                lib_ms = timer(lambda: torch.matmul(x, w))
                nbytes = x.numel() * 2 + packed.numel() + scales.numel() * 4 + M * N * 2
                b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, torch.bfloat16)
                log(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"torch.matmul(bf16 dequantised) {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")
                if M == 1:
                    for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                     ("library_ms", lib_ms), ("bound_ms", b_ms)):
                        totals[key] += val
                    totals["err"] = max(totals["err"], err)
                del w
    log(f"  one decode layer's 7 int4 matmuls at M=1 (bf16): kernel "
        f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, "
        f"library {totals['library_ms']:.4f} ms, bound {totals['bound_ms']:.4f} ms")
    return dict(name="int4_matmul", route="cuda",
                source="src/repro_torch/csrc/int4_matmul.cu",
                replaces="src/repro/kernels/int4_matmul/int4_matmul.py:53",
                max_abs_err=totals["err"], ms=totals["ms"],
                plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
                bound_by="bytes", library_ms=totals["library_ms"],
                shape="sum of the 7 qwen2.5-7b layer matmuls at M=1, bf16")


# ---------------------------------------------------------------- phases 4-6
def prompt_batch(vocab, dev, n=None, seed=0):
    rng = np.random.default_rng(seed)
    n = n or PROMPT
    return {"tokens": torch.from_numpy(rng.integers(0, vocab, (1, n))).to(dev)}


def check_f32_tokens(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log("== phase 4: kernel inside the real path (qwen2.5-7b width, 2 layers, f32)")
    cfg = get_config("qwen2.5-7b").replace(n_layers=2, dtype="float32")
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    batch = prompt_batch(cfg.vocab_size, dev, 512, seed=1)
    toks = {}
    for backend in ("cuda", "sdpa"):
        model.decode_backend = backend
        res = DecodeEngine(model, params).generate_streamed(
            batch, max_len=512 + 17, n_new=16)
        toks[backend] = res.tokens.cpu()
    same = torch.equal(toks["cuda"], toks["sdpa"])
    log(f"  greedy tokens cuda {toks['cuda'][0].tolist()}")
    log(f"  greedy tokens sdpa {toks['sdpa'][0].tolist()}: "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("f32 greedy tokens differ between cuda and sdpa")
    del params, model
    torch.cuda.empty_cache()


def main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.floor import floor_cell
    from repro_torch.core.hardware import GPU_H100
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.int4_matmul import ops as i4_ops
    from repro_torch.models.model import Model
    from repro_torch.serving import DecodeEngine
    log("== phase 5: main path, qwen2.5-7b full width (28 layers, bf16), "
        f"prompt {PROMPT}, {NEW} new tokens")
    cfg = get_config("qwen2.5-7b")
    model = Model(cfg, decode_backend="cuda", device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  random weights drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    engine = DecodeEngine(model, params)
    batch = prompt_batch(cfg.vocab_size, dev)
    max_len = PROMPT + NEW + 1
    engine.generate_streamed(prompt_batch(cfg.vocab_size, dev, 16), max_len=64,
                             n_new=4)   # warm-up (cuBLAS handles, caches)

    da_ops.launches = i4_ops.launches = 0
    runs = [engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True),
            engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True),
            engine.generate_fused(batch, max_len=max_len, n_new=NEW)]
    da_launches, i4_main = da_ops.launches, i4_ops.launches
    steps = 3 * (NEW - 1)
    log(f"  decode_attention launches {da_launches} ({cfg.n_layers} x {steps} "
        f"decode steps = {cfg.n_layers * steps}); int4_matmul launches {i4_main}")
    if da_launches != cfg.n_layers * steps:
        raise AssertionError("the main path did not run decode attention once "
                             "per layer and step")
    for i, r in enumerate(runs):
        if r.tokens.shape != (1, NEW):
            raise AssertionError(f"request {i}: tokens {tuple(r.tokens.shape)}")
    if not (torch.equal(runs[0].tokens, runs[1].tokens)
            and torch.equal(runs[0].tokens, runs[2].tokens)):
        raise AssertionError("streamed and fused greedy tokens differ")
    step_s = runs[0].step_times_s + runs[1].step_times_s
    p50 = statistics.median(step_s) * 1e3
    fc = floor_cell(cfg, GPU_H100, PROMPT)
    log(f"  p50 step {p50:.4f} ms (streamed, n={len(step_s)}); analytic floor "
        f"{fc.t_floor_ms:.4f} ms (floor_cell qwen2.5-7b, {GPU_H100.name}, ctx "
        f"{PROMPT}); R_floor {fc.t_floor_ms / p50:.4f}")
    log("  tok/s: " + ", ".join(f"{r.tokens_per_s:.2f}" for r in runs)
        + " (streamed, streamed, fused)")

    # first decode step: kernel route against the sdpa route
    with torch.inference_mode():
        tok = runs[0].tokens[:, :1]
        logits = {}
        for backend in ("cuda", "sdpa"):
            model.decode_backend = backend
            _, cache = engine.prefill(batch, max_len)
            logits[backend], _ = model.decode_step(engine.params, cache, tok)
            logits[backend] = logits[backend].float()
            del cache
        model.decode_backend = "cuda"
    if not all(bool(torch.isfinite(v).all()) for v in logits.values()):
        raise AssertionError("non-finite first-step logits")
    diff = float((logits["cuda"] - logits["sdpa"]).abs().max())
    scale = float(logits["sdpa"].abs().max())
    agree = int(logits["cuda"].argmax()) == int(logits["sdpa"].argmax())
    log(f"  first-step logits cuda vs sdpa: max_abs_diff {diff:.4g}, "
        f"max|logit| {scale:.4g}, argmax {'agrees' if agree else 'differs'} "
        f"(tol 5e-2 x max|logit|)")
    if diff > 5e-2 * scale:
        raise AssertionError("bf16 first-step logits of cuda and sdpa disagree")
    device_time(model, engine, batch, max_len, tok, p50)
    torch.cuda.empty_cache()

    log("== phase 6: int4 main path (int4_fused, quantised on the card)")
    t0 = time.perf_counter()
    engine_q = DecodeEngine(model, params, quant_path="int4_fused")
    torch.cuda.synchronize()
    log(f"  quantised in {time.perf_counter() - t0:.1f} s")
    da_ops.launches = i4_ops.launches = 0
    res = engine_q.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True)
    i4_launches, da_q = i4_ops.launches, da_ops.launches
    per_step = 7 * cfg.n_layers
    want = per_step * (NEW - 1) + per_step
    log(f"  int4_matmul launches {i4_launches} (7 x {cfg.n_layers} x {NEW - 1} "
        f"decode steps + {per_step} at prefill = {want}); decode_attention "
        f"launches {da_q}")
    if i4_launches != want:
        raise AssertionError("the int4 path did not run the int4 kernel for "
                             "every quantised matmul")
    if res.tokens.shape != (1, NEW):
        raise AssertionError(f"int4 tokens {tuple(res.tokens.shape)}")
    from repro_torch.quant import tree_weight_traffic
    p50_q = statistics.median(res.step_times_s) * 1e3
    fq = floor_cell(cfg, GPU_H100, PROMPT, weight_dtype_bytes=0.5)
    own = (tree_weight_traffic(engine_q.params) + fq.kv_bytes) / GPU_H100.hbm_bw * 1e3
    log(f"  p50 step {p50_q:.4f} ms; analytic int4 floor {fq.t_floor_ms:.4f} ms "
        f"(floor_cell weight_dtype_bytes=0.5); this path's own bytes (int4 "
        f"linears, bf16 embedding and head, bf16 KV) give {own:.4f} ms; "
        f"{res.tokens_per_s:.2f} tok/s")
    return da_launches, i4_launches


def device_time(model, engine, batch, max_len, tok, p50_ms, steps=4):
    """Kernel time per decode step under torch.profiler, against the
    unprofiled p50: the device's busy share of a step."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        _, cache = engine.prefill(batch, max_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.decode_step(engine.params, cache, tok)
            torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(r[0] for r in rows) / 1e3 / steps
    if busy == 0:
        log("  device time per step: not measured (the profiler saw no "
            "device time)")
        return
    log(f"  device time per step (torch.profiler, {steps} steps): {busy:.4f} ms "
        f"busy of the {p50_ms:.4f} ms p50 step = {busy / p50_ms:.1%}; "
        f"{sum(r[2] for r in rows) // steps} kernels per step")
    for t, name, n in sorted(rows, reverse=True)[:8]:
        log(f"    {t / 1e3 / steps:8.4f} ms/step  {n // steps:5d}x  {name[:90]}")


# ---------------------------------------------------------------- main
PENDING = [
    dict(name="paged_decode_attention",
         replaces="src/repro/kernels/paged_decode_attention/"
                  "paged_decode_attention.py:136",
         waits_for="paged KV / continuous-batching slice"),
    dict(name="ssd_update", replaces="src/repro/kernels/ssd_update/ssd_update.py:37",
         waits_for="other-families slice (mamba2 / hybrid)"),
    dict(name="rmsnorm", replaces="src/repro/kernels/rmsnorm/rmsnorm.py:24",
         waits_for="a later slice (no JAX model path calls it)"),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    smi, dev = setup()
    timer = Timer(dev)
    rows = [check_decode_attention(dev, timer), check_int4_matmul(dev, timer)]
    del timer
    torch.cuda.empty_cache()
    check_f32_tokens(dev)
    da_launches, i4_launches = main_path(dev)
    rows[0]["launches"], rows[1]["launches"] = da_launches, i4_launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    log(json.dumps({"pending_kernels": PENDING}))
    log(smi.splitlines()[0])
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
