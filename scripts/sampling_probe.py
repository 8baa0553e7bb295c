#!/usr/bin/env python3
"""Probe of token sampling on the card, at the qwen2.5-7b vocabulary
(one row of 152064 logits).

    PYTHONPATH=src python3 scripts/sampling_probe.py [--out FILE]

Reports, into ``chiprun_out/sampling_probe.json`` by default:

- the torch and CUDA versions, and whether ``torch.cuda.CUDAGraph`` has
  ``register_generator_state``;
- the smallest of 2^30 Exp(1) variates from ``exponential_`` on the card
  (f32), which ``serving/sampling.py`` clamps at the smallest normal;
- profiler device µs by kernel name and CUDA-event ms of three draws on
  one (1, V) row: greedy ``argmax``, the port's Gumbel draw
  (``sampling.sample``), and softmax + ``torch.multinomial``;
- whether ``torch.multinomial(probs, 1)`` can be captured in a CUDA
  graph with its generator registered (last: a failed capture is
  reported with its error, and nothing runs after it).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
V, TEMPERATURE, TOP_K = 152064, 0.8, 50


def event_ms(fn, reps=50) -> float:
    for _ in range(5):
        fn()
    ms = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return statistics.median(ms)


def device_us(fn, iters=20) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return {e.key: e.self_device_time_total / iters for e in rows}


def multinomial_draw(row, gen):
    lf = row.float() / TEMPERATURE
    kth = torch.sort(lf, dim=-1).values[..., -TOP_K][..., None]
    probs = torch.softmax(torch.where(lf < kth, float("-inf"), lf), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sampling_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sampling_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serving.sampling import sample
    dev = torch.device("cuda", 0)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                               "register_generator_state")}
    gen = torch.Generator(device=dev).manual_seed(0)
    e = torch.empty(2**28, device=dev)
    smallest = min(float(e.exponential_(generator=gen).min()) for _ in range(4))
    out["exponential_min_of_2^30"] = smallest
    del e
    row = torch.randn((1, V), generator=gen, device=dev).bfloat16()
    draws = {"greedy": lambda: sample(row),
             "gumbel": lambda: sample(row, gen, temperature=TEMPERATURE, top_k=TOP_K),
             "multinomial": lambda: multinomial_draw(row, gen)}
    out["draws"] = {}
    for name, fn in draws.items():
        split = device_us(fn)
        out["draws"][name] = dict(event_ms=event_ms(fn), device_us=split,
                                  device_us_total=sum(split.values()))
        print(f"{name}: {out['draws'][name]['event_ms']:.4f} ms by events, "
              f"{out['draws'][name]['device_us_total']:.2f} device µs", flush=True)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    multinomial_draw(row, gen)
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(graph):
            multinomial_draw(row, gen)
        out["multinomial_capture"] = "captured"
    except Exception as err:   # what the capture says is the finding
        out["multinomial_capture"] = f"{type(err).__name__}: {err}"[:400]
    print(f"multinomial under capture: {out['multinomial_capture']}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "draws"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
