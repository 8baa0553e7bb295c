#!/usr/bin/env python3
"""The port's span recorder (``repro_torch/core/spans.py``) on the card:
the anchor's error, the recorder's cost on a benchmark cell, and each
third of a window seen through its spans.

    PYTHONPATH=src python3 scripts/spans_probe.py anchor
    PYTHONPATH=src python3 scripts/spans_probe.py windows \\
        --cell qwen2.5-7b.serve-16 --seed 12 --order on,off,off,on
    # a rehearsal on the CPU: --device cpu --tiny --seconds 3

``anchor``: ``spans.anchor_errors`` (an event recorded right after a
synchronize, 1000 times, mapped to the host clock through a recorder's
anchor, less the host stamp after its record): the median and p99 of
|error|; then a recorder left on for 30 s with the card idle, and its
export's end error (how far the two clocks drift apart in a window).

``windows``: one process sets the cell up as ``perfbench/run.py`` does
(the kernels, the model, weights from the seed, the driver's warm-up,
the collector frozen), then serves windows of ``--seconds`` back to back
in the order given, the recorder on or off over each whole window
(capacity for every span of it).  Each window runs as three thirds back
to back; for each window its end-to-end metrics, the recorder's export
summed (``pb_spans.line``), and for each third its time per token, p95
gap and tokens/s, its time per token over the gaps that lie inside it
(without the gap from a request's last delivery before it), the
collector's and the allocator's calls in it and,
with the recorder on, each span's count, mean host ms and mean device
ms, the ticks' idle share and the idle put down to each span; and the
host's pause before the window (since the last delivery), the recorder's
turn-on time and, before the first window, the collector's pass and
freeze as ``perfbench/pb_run.py`` makes them.

One JSON line a window (or the anchor's) goes to
``chiprun_out/spans_probe.jsonl``; a summary to standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]
OUT = ROOT / "chiprun_out" / "spans_probe.jsonl"


def _write(row: dict) -> None:
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(row) + "\n")


def anchor() -> dict:
    import torch
    from repro_torch.core import spans
    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)
    errs = sorted(abs(e) for e in spans.anchor_errors(dev, 1000))
    with spans.recording(dev, capacity=1) as rec:
        time.sleep(30)
    row = {"anchor": {"median_ns": errs[len(errs) // 2],
                      "p99_ns": errs[int(0.99 * len(errs))], "max_ns": errs[-1],
                      "end_error_after_30s_ns": rec.export()["end_error_ns"]},
           "card": torch.cuda.get_device_name(dev)}
    print(json.dumps(row), file=sys.stderr)
    return row


def _third_spans(sp, t0: float, t1: float):
    import pb_spans
    lo, hi = int(t0 * 1e9), int(t1 * 1e9)
    export = dict(sp.export, spans=[s for s in sp.export["spans"]
                                    if lo <= s["t0_ns"] < hi])
    rec = dataclasses.replace(sp.record, t0=t0, t1=t1)
    return pb_spans.Spanned(rec, export)


def _span_table(sp) -> dict:
    import pb_spans
    out = {}
    for name in sorted({s["name"] for s in sp.export["spans"]}):
        host, dev = pb_spans.host_ms(sp, name), pb_spans.device_ms(sp, name)
        out[name] = {"n": len(host), "host_ms": pb_spans.mean(host),
                     "device_ms": pb_spans.mean(dev)}
    return out


def _tpot_inside_ms(rec):
    """Time per output token over the gaps whose both deliveries lie in
    ``rec``'s span: a request's first delivery in it counts from itself,
    not from its delivery before the span."""
    span = tokens = 0.0
    for r in rec.requests:
        idx = [k for k, (t, _) in enumerate(r.deliveries) if rec.within(t)]
        if len(idx) > 1:
            span += r.deliveries[idx[-1]][0] - r.deliveries[idx[0]][0]
            tokens += sum(r.deliveries[k][1] for k in idx[1:])
    return 1e3 * span / tokens if tokens else None


def windows(cell_name: str, seed: int, seconds: float, order,
            device: str = "cuda", tiny: bool = False) -> list:
    import torch
    import pb_counts
    import pb_manifest
    import pb_metrics
    import pb_model
    import pb_run
    import pb_spans
    from pb_drive import DRIVERS
    from repro_torch.core import spans
    from repro_torch.kernels import _build

    if tiny:
        import pb_tiny
        cell = pb_tiny.cell(cell_name)
    else:
        cell = pb_manifest.load_cell(pb_manifest.load(ROOT), cell_name)
    cfg, spec = cell.config, cell.traffic
    dev = torch.device(device)
    card = dev.type == "cuda"
    if card and dev.index is None:
        dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    if card:
        _build.build_all()
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)
    model = pb_model.port_model(cfg, dev)
    weights = pb_model.make_weights(cfg, seed, dev)
    driver = DRIVERS[spec["driver"]](model, pb_model.port_params(cfg, weights),
                                     spec, seed)
    shape = pb_counts.Shape.of(cfg)
    rows = []
    with torch.inference_mode():
        driver.warm()
        pb_run._sync(dev)
        t = time.perf_counter()
        gc.collect()
        gc.freeze()
        gc_s = time.perf_counter() - t
        setup_s = time.perf_counter() - T_START
        for k, mode in enumerate(order):
            t_on = time.perf_counter()
            ctx = (spans.recording(dev, capacity=1 << 16) if mode == "on"
                   else contextlib.nullcontext())
            thirds, counts = [], []
            with ctx as rec:
                turn_on_s = time.perf_counter() - t_on
                last = max((d[-1][0] for d in (r.deliveries for r in driver.requests)
                            if d), default=None)
                for _ in range(3):
                    before = pb_run._counters(dev)
                    thirds.append(driver.window(seconds / 3))
                    after = pb_run._counters(dev)
                    counts.append({c: after[c] - before[c] for c in before})
            whole = dataclasses.replace(thirds[0], t1=thirds[-1].t1)
            run = pb_metrics.Run(cell.name, cfg, spec, shape, setup_s, whole)
            row = {"cell": cell.name, "seed": seed, "window": k, "recorder": mode,
                   "metrics": {}, "thirds": [], "turn_on_s": turn_on_s,
                   "gc_collect_freeze_s": gc_s if k == 0 else None,
                   "pause_before_window_s": None if last is None
                   else whole.t0 - last,
                   "card": torch.cuda.get_device_name(dev) if card else "cpu"}
            for m in cell.end_to_end:
                if m["name"] != "setup_s":
                    v = pb_manifest.reader(m["name"])(run)
                    row["metrics"][m["name"]] = None if v is None else float(v)
            sp = None
            if rec is not None:
                sp = pb_spans.Spanned(whole, rec.export())
                row["spans"] = pb_spans.line(sp)
                row["readings"] = pb_spans.readings(sp)
            for third, count in zip(thirds, counts):
                t = pb_metrics.tpot_s(third)
                p = pb_metrics.p95(pb_metrics.decode_gaps_s(third))
                entry = {"tpot_ms": t and 1e3 * t, "p95_ms": p and 1e3 * p,
                         "tpot_inside_ms": _tpot_inside_ms(third),
                         "tokens_per_s": pb_metrics.tokens_delivered(third)
                         / (third.t1 - third.t0), "counters": count}
                if sp is not None:
                    sub = _third_spans(sp, third.t0, third.t1)
                    entry["spans"] = _span_table(sub)
                    entry["tick_idle"] = pb_spans.tick_idle(sub)
                    if sub.has_device():
                        idle, n_short, short_s = pb_spans.idle_by_span(sub)
                        entry["idle_ms"] = {n: 1e3 * v for n, v in sorted(
                            idle.items(), key=lambda kv: -kv[1])}
                        entry["short_gaps"] = [n_short, 1e3 * short_s]
                row["thirds"].append(entry)
            _write(row)
            rows.append(row)
            print(f"{cell.name} seed {seed} window {k} recorder {mode}: "
                  + ", ".join(f"{n} {v:.4f}" for n, v in row["metrics"].items()
                              if v is not None)
                  + "; thirds tpot " + " ".join(
                      f"{e['tpot_ms']:.3f}" for e in row["thirds"] if e["tpot_ms"])
                  + " (inside " + " ".join(
                      f"{e['tpot_inside_ms']:.3f}" for e in row["thirds"]
                      if e["tpot_inside_ms"]) + ")"
                  + f"; pause before {row['pause_before_window_s']}"
                  f", turn-on {turn_on_s:.3f} s",
                  file=sys.stderr, flush=True)
            if sp is not None:
                print("  spans: " + row["spans"], file=sys.stderr, flush=True)
                print("  readings: " + json.dumps(row["readings"]),
                      file=sys.stderr, flush=True)
    driver.close()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["anchor", "windows"])
    ap.add_argument("--cell", default="qwen2.5-7b.b1-ctx2048")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 17)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--order", default="off,on,on,off")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the cell cut to a CPU rehearsal's size (pb_tiny.py)")
    args = ap.parse_args()
    if args.what == "anchor":
        _write(anchor())
        return 0
    order = args.order.split(",")
    if set(order) - {"on", "off"}:
        ap.error("--order is a list of on and off")
    windows(args.cell, args.seed, args.seconds, order, args.device, args.tiny)
    if len(set(order)) == 2:
        by = {m: [] for m in ("on", "off")}
        for row in [json.loads(x) for x in OUT.read_text().splitlines()]:
            if row.get("cell") == args.cell and row.get("seed") == args.seed:
                by[row["recorder"]].append(row["metrics"])
        for name in by["on"][0]:
            on = [r[name] for r in by["on"] if r[name] is not None]
            off = [r[name] for r in by["off"] if r[name] is not None]
            if on and off:
                a, b = statistics.median(on), statistics.median(off)
                print(f"{args.cell} {name}: recorder on {a:.4f} off {b:.4f} "
                      f"({100 * (a - b) / b:+.2f}%)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
