"""One run of one cell: set-up, the measured window, the traced window
(``trace``), the check of the output, and the result line.

Set-up is everything from the start of the process to the first timed
request: importing, building (first run in a checkout) or loading the
port's kernels, making the weights, and the driver's warm-up at the
window's own shapes, which captures the decode graph.  Nothing compiles
in the window.  With ``trace`` the window runs as without it; then the
driver serves a few more requests or ticks of the same traffic under
``torch.profiler``, the traced window.  The peak of device memory is read
before the program's state is freed and the reference runs.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Tuple

import torch

import pb_check
import pb_counts
import pb_manifest
import pb_model
import pb_trace
from pb_drive import DRIVERS
import pb_metrics
from pb_metrics import Run, window_requests


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters(device) -> dict:
    """What can stall a window without the program asking for it: the
    collector's passes by generation, and the allocator's calls to the
    driver and its retries after freeing its cache."""
    out = {f"gc gen{g}": s["collections"] for g, s in enumerate(gc.get_stats())}
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out.update({"cudaMalloc": stats.get("num_device_alloc", 0),
                    "alloc retries": stats.get("num_alloc_retries", 0)})
    return out


def run(cell: pb_manifest.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Tuple[dict, dict]:
    """(the result line's object without ``check``, the numbers compared)."""
    cfg, spec = cell.config, cell.traffic
    on_card = device.type == "cuda"
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if on_card:
        torch.set_num_threads(1)     # the host's work is the main thread's
        from repro_torch.kernels import _build
        _build.build_all()
        torch.cuda.set_device(device)
        torch.zeros((), device=device)    # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    model = pb_model.port_model(cfg, device)
    weights = pb_model.make_weights(cfg, seed, device)
    driver = DRIVERS[spec["driver"]](model, pb_model.port_params(cfg, weights),
                                     spec, seed)
    traffic = driver.traffic
    traced = summary = prof = None
    _sync(device)
    marks.append(("kernels, model, weights", time.perf_counter()))
    with torch.inference_mode():
        driver.warm()
        _sync(device)
        # what set-up made stays out of the collector's scans in the window
        gc.collect()
        gc.freeze()
        marks.append(("warm-up", time.perf_counter()))
        setup_s = marks[-1][1] - t_start
        print("set-up s: " + ", ".join(
            f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])),
            file=sys.stderr)
        before = _counters(device)
        rec = driver.window(seconds)
        after = _counters(device)
        print("window: " + pb_metrics.thirds(rec) + "; in it "
              + ", ".join(f"{k} {after[k] - before[k]}" for k in before),
              file=sys.stderr)
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            with torch.profiler.record_function(pb_trace.SPAN):
                traced = driver.traced()
                _sync(device)
            prof.stop()
        driver.finish(rec)
        _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.close()
    del driver, model
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if prof is not None:
        summary = pb_trace.summarize(prof)
        del prof
    correct, numbers = pb_check.judge(cfg, weights, traffic, rec, seed,
                                      cell.limits)
    reqs = window_requests(rec)
    out = {"correct": correct, "attempted": len(reqs),
           "failed": sum(r.status not in ("ok", "open") for r in reqs)}
    state = Run(cell.name, cfg, spec, pb_counts.Shape.of(cfg), setup_s, rec,
                traced, summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = pb_manifest.reader(m["name"])(state)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
    return out, numbers
