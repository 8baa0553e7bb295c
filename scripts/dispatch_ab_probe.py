#!/usr/bin/env python3
"""The paper's dispatch A/B (its table 2 and table 4) at full width on one
NVIDIA card, under the port's measurement protocol (``core/protocol.py``:
5 warm-up and 30 measured steps, p50 per arm, within-session pairs over
N fresh sessions, 10,000-resample bootstrap 95% CI).

    PYTHONPATH=src python3 scripts/dispatch_ab_probe.py [--sessions N] \
        [--parent DIR] [--only NAME]

Cells (random weights drawn on the card from seed 0 and shared by the
sessions; a session is its own cache, prefilled from its seed, and new
executors; the cache's state is put back before each arm, so that both
arms of a session decode over one context):

- ``table2/bf16``, ``table2/int4_fused``: qwen2.5-7b, batch 1, ctx 2048,
  ``Model.step_program``'s executors: eager against full_jit and
  stage_jit against full_jit, N sessions each (10 by default); the mean
  paired speedup, its CI and CV beside the paper's 1.259x [1.253, 1.267]
  (H100, ctx 2048), and R_floor per arm against ``floor_cell``.
- ``table4/B=b``: the batch sweep, b = 1, 2, 4, 8 (bf16), eager against
  full_jit, 3 sessions (the paper's 1.259x falls to 1.036x by b=4).
- ``engine/mamba2-2.7b``, ``engine/zamba2-1.2b``: ``DecodeEngine``'s
  decode stage under the eager executor (plain ``decode_step`` calls)
  against the full_jit one (the graph its streamed loop replays; the ssm
  and hybrid families have no step program), 3 sessions.
- Host time beside every arm of every session: the calls' host wall and
  the main thread's CPU time per step (what the host spent enqueueing a
  step, and how much of that it was on a core), so that a spread of the
  eager arm from one call to the next can be read against the host.
- For every graph arm, one profiled replay (and one profiled eager step
  beside it): kernels (and copies), summed kernel time, the span from
  the first kernel's start to the last one's end, the in-step device us
  per call of kernels 1, 3, 4 and 5, and the median and the 20 largest
  gaps between consecutive kernels.
- ``--parent DIR``: the eager qwen2.5-7b bf16 p50 (plain ``decode_step``
  calls, 5 + 30 steps) through an older checkout and this one in turns
  (parent, this, this, parent), each a process of its own.

Writes ``chiprun_out/dispatch_ab.json`` and prints one JSON line per
cell.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import device_events, prompt_batch, step_view  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.dispatch import StepProgram  # noqa: E402
from repro_torch.core.floor import floor_cell  # noqa: E402
from repro_torch.core.hardware import GPU_H100  # noqa: E402
from repro_torch.core.protocol import run_ab  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402

OUT = ROOT / "chiprun_out"
PROMPT = 2048
MAX_LEN = PROMPT + 64          # 5 + 30 steps past the prompt, and the profiles
PAPER = {"mean_speedup": 1.259, "ci95": [1.253, 1.267], "n_sessions": 10}
KERNELS = ("decode_attention_mma", "int4_gemv", "ssd_update_kernel", "rmsnorm_kernel")
CELLS = ("table2", "table4", "engine", "parent")

EAGER_CHILD = """
import statistics, sys, time, numpy as np, torch
sys.path.insert(0, "src")
from repro_torch.configs import get_config
from repro_torch.models.model import Model
dev = torch.device("cuda", 0)
cfg = get_config("qwen2.5-7b")
model = Model(cfg, decode_backend="cuda", device=dev)
params = model.init(torch.Generator(device=dev).manual_seed(0))
rng = np.random.default_rng(0)
batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048))).to(dev)}
with torch.inference_mode():
    cache = model.init_cache(1, 2048 + 64)
    logits, _ = model.prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    times = []
    for i in range(35):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        if i >= 5:
            times.append(time.perf_counter() - t0)
print(statistics.median(times) * 1e3)
"""


def log(*a):
    print(*a, flush=True)


def gaps(events, n=20):
    """The ``n`` largest idle gaps between consecutive kernels of one
    step (us), with the kernels on both sides and the gaps' median."""
    kernels = [e for e in events if e[3] == "kernel"]
    out = sorted(((b[0] - a[1], a[2][:60], b[2][:60])
                  for a, b in zip(kernels, kernels[1:])), reverse=True)
    return ([dict(us=g, after=x, before=y) for g, x, y in out[:n]],
            out[len(out) // 2][0] if out else None)


def profile(fn):
    ev = device_events(fn)
    view = step_view(ev, KERNELS)
    view["largest_gaps"], view["median_gap_us"] = gaps(ev)
    view["gaps_ms"] = view["span_ms"] - view["kernel_ms"]
    return view


def show(what, v):
    top = ", ".join(f"{g['us']:.1f} ({g['after'][:24]} -> {g['before'][:24]})"
                    for g in v["largest_gaps"][:3])
    log(f"  profiled {what}: {v['kernels']} kernels (+{v['copies']} copies), "
        f"{v['kernel_ms']:.4f} ms summed, span {v['span_ms']:.4f} ms, median gap "
        f"{v['median_gap_us']:.2f} us, largest gaps us {top}; us per call "
        f"{v['us_per_call']}")


class Sessions:
    """One session's cache at a time, prefilled from its seed; each
    ``get`` puts its state back to the prefilled one, before an arm."""

    def __init__(self, model, params, batch_size):
        self.model, self.params, self.B = model, params, batch_size
        self.s, self.cache = None, None

    def get(self, s):
        if self.s != s:
            self.cache = self.saved = None          # drop the last session first
            torch.cuda.empty_cache()
            model, cfg = self.model, self.model.cfg
            rows = [prompt_batch(cfg.vocab_size, model.device, PROMPT, seed=1000 * s + b)
                    ["tokens"] for b in range(self.B)]
            self.cache = model.init_cache(self.B, MAX_LEN)
            logits, _ = model.prefill(self.params, {"tokens": torch.cat(rows)}, self.cache)
            self.tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
            self.saved = {k: v.clone() for k, v in self.cache.items()
                          if k in ("pos", "h", "conv")}
            self.s = s
        for k, v in self.saved.items():
            self.cache[k].copy_(v)
        return self.cache, self.tok


def executor_arm(sessions, mode, program, host=None):
    """The arm ``mode`` of ``program(cache)``'s executors over each
    session's cache.  With ``host`` (a list), each session's calls add a
    row of host load to it."""
    def make(s):
        cache, tok = sessions.get(s)
        run = program(cache).executor(mode)
        state = {"tokens": tok, "cache": cache}
        if host is None:
            return lambda: run(state)["logits"]
        row = dict(arm=mode, session=s, calls=0, wall_s=0.0, cpu_s=0.0)
        host.append(row)

        def call():
            w, c = time.perf_counter(), time.thread_time()
            out = run(state)["logits"]
            row["cpu_s"] += time.thread_time() - c
            row["wall_s"] += time.perf_counter() - w
            row["calls"] += 1
            return out
        return call
    return make


def host_rows(host):
    """Per arm and session: host ms and main-thread CPU ms per call, and
    their ratio."""
    return [dict(arm=r["arm"], session=r["session"],
                 host_ms_per_call=r["wall_s"] / r["calls"] * 1e3,
                 cpu_ms_per_call=r["cpu_s"] / r["calls"] * 1e3,
                 cpu_share=r["cpu_s"] / r["wall_s"]) for r in host if r["calls"]]


def ab_row(name, ab, floor_ms=None, host=None):
    summ = ab.summary()
    row = dict(cell=name, **summ)
    if host is not None:
        row["host"] = host_rows(host)
        for r in row["host"]:
            if r["arm"] == "eager":
                log(f"  host, eager session {r['session']}: {r['host_ms_per_call']:.4f} "
                    f"ms a call, main thread on a core {r['cpu_ms_per_call']:.4f} ms "
                    f"({r['cpu_share']:.4f})")
    if floor_ms:
        row["floor_ms"] = floor_ms
        row["r_floor"] = [floor_ms / summ["baseline_mean_ms"],
                          floor_ms / summ["treated_mean_ms"]]
    lo, hi = summ["speedup_ci95"]
    log(f"{name}: {summ['baseline_mean_ms']:.4f} -> {summ['treated_mean_ms']:.4f} ms, "
        f"speedup {summ['mean_speedup']:.4f}x [{lo:.4f}, {hi:.4f}], cv "
        f"{summ['speedup_cv']:.4f}, n={summ['n_sessions']}"
        + (f"; R_floor {row['r_floor'][0]:.4f} -> {row['r_floor'][1]:.4f}"
           if floor_ms else "") + f" (paper {PAPER['mean_speedup']}x "
        f"{PAPER['ci95']})")
    return row


def table2(result, n, quant, model, params):
    cfg = model.cfg
    fc = floor_cell(cfg, GPU_H100, PROMPT,
                    weight_dtype_bytes=0.5 if quant == "int4_fused" else 2)
    sessions = Sessions(model, params, 1)

    def program(cache):
        return model.step_program(params, cache)
    for base in ("eager", "stage_jit"):
        host = []
        ab = run_ab(executor_arm(sessions, base, program, host),
                    executor_arm(sessions, "full_jit", program, host),
                    n_sessions=n, name=f"table2/{quant}/{base}")
        result["cells"].append(ab_row(f"table2/{quant}/{base}_vs_full_jit", ab,
                                      fc.t_floor_ms, host))
    views = {}
    for mode in dispatch.MODES:
        cache, tok = sessions.get(0)
        run = model.step_program(params, cache).executor(mode)
        views[mode] = profile(lambda: run({"tokens": tok, "cache": cache}))
        show(f"{quant} {mode} step", views[mode])
    result["profiles"][f"table2/{quant}"] = views


def table4(result, model, params):
    for B in (1, 2, 4, 8):
        sessions = Sessions(model, params, B)
        host = []

        def program(cache):
            return model.step_program(params, cache)
        ab = run_ab(executor_arm(sessions, "eager", program, host),
                    executor_arm(sessions, "full_jit", program, host),
                    n_sessions=3, name=f"table4/B={B}")
        result["cells"].append(ab_row(f"table4/B={B}/eager_vs_full_jit", ab, host=host))
        del sessions


def engine_cells(result, dev):
    for name in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_config(name)
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        sessions = Sessions(model, params, 1)
        engine = DecodeEngine(model, params)
        fc = floor_cell(cfg, GPU_H100, PROMPT)
        host = []

        def program(cache):
            return StepProgram([engine.decode_stage])
        ab = run_ab(executor_arm(sessions, "eager", program, host),
                    executor_arm(sessions, "full_jit", program, host),
                    n_sessions=3, name=f"engine/{name}")
        result["cells"].append(ab_row(f"engine/{name}/eager_vs_graph", ab,
                                      fc.t_floor_ms, host))
        views = {"eager": profile(executor_arm(sessions, "eager", program)(0)),
                 "graph": profile(executor_arm(sessions, "full_jit", program)(0))}
        for arm, v in views.items():
            show(f"{name} {arm} step", v)
        result["profiles"][f"engine/{name}"] = views
        del sessions, engine, params, model
        torch.cuda.empty_cache()


def parent_turns(result, parents):
    for parent in parents:
        p50 = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            tree = parent if who == "parent" else ROOT
            out = subprocess.run([sys.executable, "-c", EAGER_CHILD], cwd=tree,
                                 env=dict(os.environ, PYTHONPATH=str(tree / "src")),
                                 capture_output=True, text=True, check=True,
                                 timeout=900).stdout
            p50[who].append(float(out.strip().splitlines()[-1]))
        row = dict(cell="parent/qwen2.5-7b bf16 eager decode_step p50 ms",
                   tree=str(parent), parent_ms=p50["parent"], this_ms=p50["this"])
        log(json.dumps(row))
        result["cells"].append(row)


@torch.inference_mode()
def run(args, dev, result):
    only = set(args.only or CELLS)
    if only & {"table2", "table4"}:
        cfg = get_config("qwen2.5-7b")
        model = Model(cfg, decode_backend="cuda", device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        if "table2" in only:
            table2(result, args.sessions, "bf16", model, params)
        if "table4" in only:
            table4(result, model, params)
        if "table2" in only:
            qparams = quantize_tree(params, "int4_fused")
            table2(result, args.sessions, "int4_fused", model, qparams)
            del qparams
        del params, model
        torch.cuda.empty_cache()
    if "engine" in only:
        engine_cells(result, dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=10,
                    help="fresh sessions per table-2 A/B")
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="root of another checkout whose eager step to time "
                         "in turns (repeatable)")
    ap.add_argument("--only", choices=CELLS, action="append",
                    help="run only these cells (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dispatch_ab_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": smi, "torch": torch.__version__, "paper": PAPER,
              "cells": [], "profiles": {}}
    t0 = time.perf_counter()
    OUT.mkdir(exist_ok=True)

    def save():
        result["seconds"] = time.perf_counter() - t0
        (OUT / "dispatch_ab.json").write_text(json.dumps(result, indent=1))
    run(args, dev, result)
    save()
    if args.parent and (not args.only or "parent" in args.only):
        parent_turns(result, [p.resolve() for p in args.parent])
        save()
    log(f"{smi}; {result['seconds']:.1f} s; wrote {OUT / 'dispatch_ab.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
