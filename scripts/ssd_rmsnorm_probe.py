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
LAUNCH = {"ssd_update": "ssd_update_launch", "rmsnorm": "rmsnorm_launch"}
SSD_SHAPES = {"mamba2-2.7b": ((1, 80, 64, 128, 1), 64),   # (B, H, P, N, G), states b2b
              "zamba2-1.2b": ((1, 64, 64, 64, 1), 96)}
NORM_SHAPES = [(R, D) for R in (1, 2048) for D in (2560, 3584, 5120)]
NORM_B2B = {1: 129, 2048: 8}        # decode rows of a mamba2 step; prompts past L2
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


def build_variants(trees: dict) -> dict:
    """Every variant and timeline copy of every tree's two sources, built
    in parallel: {(tree, kernel): {variant: (cdll, stamps or None)}}."""
    jobs = {}
    for tag, (root, _) in trees.items():
        for kernel in KERNELS:
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
    ap.add_argument("--only", choices=KERNELS, help="one of the two kernels")
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
    variants = build_variants(trees)
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
    OUT.mkdir(exist_ok=True)
    (OUT / "ssd_rmsnorm_probe.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
