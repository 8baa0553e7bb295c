#!/usr/bin/env python3
"""The int4 moe decode step on one NVIDIA card, by kernel kind, for this
tree and older ones: qwen2-moe-a2.7b at full width and depth (24 layers,
60 experts, bf16, random weights drawn on the card), ``int4_fused``
(attention and shared-expert weights through kernel 3, the 3-D expert
stacks multiplied by a bf16 dequantisation), prompt 2048, 32 new tokens.

    PYTHONPATH=src python3 scripts/moe_int4_probe.py [--parent DIR ...]

Each tree runs in a subprocess of its own with ``PYTHONPATH=<tree>/src``,
in turns (each parent, this tree, this tree, each parent), and prints:

- ``graph_p50_ms``: the engine's graph step (``generate_streamed`` after
  a capturing request, 31 timed steps);
- ``eager_p50_ms``: ``measure_cell`` (5 + 30) of plain ``decode_step``
  calls on a prefilled cache of its own;
- ``device_ms`` and ``kernels``: torch.profiler over 2 eager decode
  steps, per step, and ``busy_share`` = device ms / graph p50;
- ``by_kind``: ms and kernels a step by kind (``KINDS``, the first kind
  whose keys a kernel's name holds), and the 12 kernels with the most
  device time;
- ``weight_bytes``: ``tree_weight_traffic`` of the quantised params.

Writes ``chiprun_out/moe_int4_probe.json``.  Needs a card (and nvcc for
the kernels).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, PROMPT, NEW, PROFILED_STEPS = "qwen2-moe-a2.7b", 2048, 32, 2
# kernel kinds by name, the first that matches wins (int8 is ``signed
# char`` in a kernel's template arguments, uint8 ``unsigned char``)
KINDS = (("dequantize kernel", ("dequantize_kernel",)),
         ("kernel 3 (int4 GEMV / GEMM)", ("int4_gemv", "int4_gemm")),
         ("kernel 1 (decode attention)", ("decode_attention",)),
         ("kernel 5 (rmsnorm)", ("rmsnorm",)),
         ("uint8 / int8 elementwise", ("unsigned char", "signed char")),
         ("GEMMs", ("gemm", "nvjet", "cutlass", "gemv")),
         ("elementwise, copies and casts", ("elementwise", "copy", "fill", "cat",
                                            "index", "where", "scatter", "gather")))


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, keys in KINDS if any(x in low for x in keys)), "other")


def child() -> dict:
    """One tree's numbers (runs in the subprocess)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import measure_cell
    from repro_torch.models.model import Model
    from repro_torch.quant import tree_weight_traffic
    from repro_torch.serving import DecodeEngine
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = DecodeEngine(model, params, quant_path="int4_fused")
    del params
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    batch, max_len = {"tokens": tokens}, PROMPT + NEW + 1
    engine.generate_streamed(batch, max_len=max_len, n_new=NEW)      # capture
    res = engine.generate_streamed(batch, max_len=max_len, n_new=NEW, timed=True)
    graph_p50 = statistics.median(res.step_times_s) * 1e3
    tok = res.tokens[:, :1]
    with torch.inference_mode():
        cache = engine.new_cache(1, PROMPT + 64)
        engine.model.prefill(engine.params, batch, cache)
        eager = measure_cell(lambda: engine.model.decode_step(engine.params, cache, tok)[0],
                             name="eager").p50_ms
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                engine.model.decode_step(engine.params, cache, tok)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    by_kind = {}
    for e in events:
        k = by_kind.setdefault(kind_of(e.key), {"ms": 0.0, "kernels": 0.0})
        k["ms"] += e.self_device_time_total / 1e3 / PROFILED_STEPS
        k["kernels"] += e.count / PROFILED_STEPS
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / PROFILED_STEPS
    return {"graph_p50_ms": graph_p50, "eager_p50_ms": eager, "device_ms": device_ms,
            "busy_share": device_ms / graph_p50,
            "kernels": sum(e.count for e in events) / PROFILED_STEPS,
            "by_kind": by_kind,
            "top": [(e.key[:120], e.count / PROFILED_STEPS,
                     e.self_device_time_total / 1e3 / PROFILED_STEPS) for e in events[:12]],
            "weight_bytes": tree_weight_traffic(engine.params),
            "tokens": res.tokens[0].tolist()}


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an older checkout to run in turns with this one")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("moe_int4_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    parents = [p.resolve() for p in a.parent]
    order = parents + [ROOT, ROOT] + parents
    out = {"card": smi, "runs": []}
    for tree in order:
        r = run_tree(tree)
        who = "this tree" if tree == ROOT else f"parent {tree}"
        out["runs"].append({"tree": who, **r})
        print(f"{who}: graph p50 {r['graph_p50_ms']:.4f} ms, eager p50 "
              f"{r['eager_p50_ms']:.4f} ms, device {r['device_ms']:.4f} ms a step "
              f"({r['kernels']:.0f} kernels, busy {r['busy_share']:.1%} of the graph "
              f"p50), weights charged {r['weight_bytes'] / 1e9:.4f} GB", flush=True)
        for kind, k in sorted(r["by_kind"].items(), key=lambda kv: -kv[1]["ms"]):
            print(f"    {kind}: {k['ms']:.4f} ms, {k['kernels']:.0f} kernels a step")
        for name, calls, ms in r["top"]:
            print(f"      {ms:9.4f} ms {calls:6.0f}x {name}")
    toks = {json.dumps(r["tokens"]) for r in out["runs"]}
    print(f"greedy tokens equal across the runs: {len(toks) == 1}")
    dest = ROOT / "chiprun_out" / "moe_int4_probe.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
