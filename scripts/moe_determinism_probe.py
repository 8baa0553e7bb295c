#!/usr/bin/env python3
"""Whether the paged moe decode gives the same bits on every call, on one
NVIDIA card.

    PYTHONPATH=src python3 scripts/moe_determinism_probe.py [--runs N]

A 2-layer qwen2-moe-a2.7b at full width (60 experts, bf16, weights from
seed 0), as the card test ``test_moe_scheduler_graph_replays_equal_plain_calls``
builds it.  Two parts:

- **steps**: one paged decode step (``Model.decode_step``) called
  ``--runs`` times from copies of one cache, eagerly, on 4 lanes: two
  live lanes on their own pages, and two inactive lanes that both write
  row 4 of the garbage page 0 with different values, one of which reads
  page 0 through its block table (a free lane).  For each lane it
  prints how many calls gave logits whose bits differ from the first
  call's.  With a scatter whose order varies, the free lane's logits
  vary, and through the experts' capacity the live lanes' may too.
- **scheduler**: the card test's five sessions through three slots
  (paged, page 16, ``steps_per_tick`` 1 and 4), run ``--runs`` times with
  the decode step captured as a CUDA graph and ``--runs`` times with
  plain calls, alternating; each run's event log is held against the
  first plain run's, and the first event that differs is printed.

Writes ``chiprun_out/moe_determinism_probe.json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import SessionRequest, SlotScheduler  # noqa: E402

SPEC = [(40, 2), (70, 9), (55, 11), (33, 3), (47, 2)]   # (prompt, new tokens)


def requests(cfg):
    g = torch.Generator().manual_seed(7)
    return [SessionRequest(f"s{i}", torch.randint(0, cfg.vocab_size, (n,),
                                                  generator=g).numpy(), new)
            for i, (n, new) in enumerate(SPEC)]


def steps_part(model, params, runs: int) -> dict:
    """Logits of one eager paged decode step, ``runs`` times from copies of
    one cache: calls whose bits differ from the first, per lane."""
    dev = model.device
    cache = model.init_cache(4, 64, paged=True, page_size=16)
    g = torch.Generator(device=dev).manual_seed(1)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=g, device=dev))
    bt = cache["block_table"]
    bt.zero_()
    bt[0, :3] = torch.tensor([1, 2, 3])
    bt[1, :3] = torch.tensor([5, 6, 7])
    bt[3, :3] = torch.tensor([9, 10, 11])
    # lanes 0, 1 live; lane 2 free (its row all page 0) at position 4;
    # lane 3 spent at position 20: both write row 4 of page 0
    cache["pos"].copy_(torch.tensor([20, 37, 4, 20], dtype=cache["pos"].dtype))
    tokens = torch.tensor([[11], [22], [33], [44]], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, False, False], device=dev)
    first, differ = None, [0, 0, 0, 0]
    for _ in range(runs):
        c = {k: v.clone() for k, v in cache.items()}
        logits, _ = model.decode_step(params, c, tokens, active=active)
        bits = logits.view(torch.int16).clone()
        if first is None:
            first = bits
            continue
        for lane in range(4):
            differ[lane] += int(not torch.equal(bits[lane], first[lane]))
    return {"runs": runs, "calls_differing_by_lane": differ,
            "lanes": ["live", "live", "free, inactive", "spent, inactive"]}


def scheduler_part(model, params, cfg, runs: int, K: int) -> dict:
    """The card test's sessions, graph and plain runs alternating."""
    reqs = requests(cfg)
    out = {"K": K, "runs": []}
    ref = None
    for i in range(2 * runs):
        capture = i % 2 == 1
        sched = SlotScheduler(model, params, n_slots=3, max_len=96, paged=True,
                              page_size=16, steps_per_tick=K)
        sched._progs.capture = capture
        for r in reqs:
            sched.submit(r)
        events = sched.run().events
        if ref is None:
            ref = events
        diff = next((j for j, (a, b) in enumerate(zip(events, ref)) if a != b),
                    None if len(events) == len(ref) else min(len(events), len(ref)))
        rec = {"mode": "graph" if capture else "plain", "equal_to_first_plain":
               diff is None, "first_difference": None if diff is None else
               [diff, repr(events[diff]) if diff < len(events) else None,
                repr(ref[diff]) if diff < len(ref) else None]}
        out["runs"].append(rec)
        print(f"  K={K} run {i // 2} {rec['mode']:5s}: "
              + ("equal to the first plain run" if diff is None else
                 f"differs at event {diff}: {rec['first_difference'][1]} against "
                 f"{rec['first_difference'][2]}"), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen2-moe-a2.7b").replace(n_layers=2)
    model = Model(cfg, decode_backend="cuda", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    res = {"card": smi}
    res["steps"] = steps_part(model, params, args.runs * 4)
    print(f"steps: {res['steps']['runs']} eager calls from one cache; calls whose "
          f"logits differ from the first, by lane "
          f"({', '.join(res['steps']['lanes'])}): "
          f"{res['steps']['calls_differing_by_lane']}", flush=True)
    res["scheduler"] = []
    for K in (1, 4):
        part = scheduler_part(model, params, cfg, args.runs, K)
        n_off = sum(not r["equal_to_first_plain"] for r in part["runs"])
        print(f"scheduler K={K}: {n_off} of {len(part['runs'])} runs differ from the "
              f"first plain run", flush=True)
        res["scheduler"].append(part)
    dest = ROOT / "chiprun_out" / "moe_determinism_probe.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
