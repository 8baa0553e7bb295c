"""A spanned phase, and what its spans add up to.

A spanned phase is a window of a cell's traffic served with the port's
span recorder on (``repro_torch/core/spans.py``) and no profiler: host
spans at the engine's and the scheduler's layer boundaries, and device
intervals from CUDA events on the same clock.  ``phase`` runs one
through a driver (None where the port has no recorder), and
``readings`` gives the five numbers a spanned phase is read for.  The harness does
not run one yet: ``pb_run.py`` would call ``phase`` after the profiled
window of a ``--trace 1`` run (PERF.md §7); ``scripts/spans_probe.py``
runs whole windows through the same arithmetic.

Each device idle gap is put down to the innermost span open at its
middle (``pb_trace._attribute``); the phase itself is the harness's
span, so a gap outside the port's spans goes to it.  A gap shorter than
the anchor's error (``MIN_GAP_NS``) is not attributed: it is counted
apart, as short.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple

import pb_trace
from pb_drive import Record

# the anchor's error, with room: |an event mapped to the host clock - the
# host stamp| had a p99 of 1.8 us over 1000 events on an H100 80GB HBM3 at
# 700 W (the clocks' drift, ~2 ppm, is taken out at export)
MIN_GAP_NS = 5_000
HARNESS = "pb.spanned"


@dataclasses.dataclass
class Spanned:
    record: Record      # the phase's window, as the driver kept it
    export: dict        # the recorder's ``export()``

    def named(self, name: str) -> List[dict]:
        return [s for s in self.export["spans"] if s["name"] == name]

    def has_device(self) -> bool:
        return any(s["device"] for s in self.export["spans"])


def phase(driver, seconds: float, device) -> Optional[Spanned]:
    """``driver.window(seconds)`` with the recorder on; None where the port
    has none."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    with spans.recording(device) as rec:
        record = driver.window(seconds)
    return Spanned(record, rec.export())


def host_ms(sp: Optional[Spanned], name: str) -> List[float]:
    if sp is None:
        return []
    return [(s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in sp.named(name)]


def device_ms(sp: Optional[Spanned], name: str) -> List[float]:
    if sp is None:
        return []
    return [(s["device"][1] - s["device"][0]) * 1e-6 for s in sp.named(name)
            if s["device"]]


def mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def median(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def _busy(spans: List[dict]) -> List[Tuple[int, int]]:
    return pb_trace._union([tuple(s["device"]) for s in spans if s["device"]])


def _overlap(busy: List[Tuple[int, int]], lo: int, hi: int) -> int:
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in busy)


def decode_idle(sp: Optional[Spanned]) -> Optional[Tuple[int, int]]:
    """(idle ns, span ns) of the device over each engine request's decode:
    from its first replay's start to its last sample's end, summed over
    requests; None without device intervals."""
    if sp is None:
        return None
    by_request: Dict[object, List[dict]] = collections.defaultdict(list)
    for s in sp.named("engine.replay") + sp.named("engine.sample"):
        if s["device"]:
            by_request[s["request"]].append(s)
    idle = total = 0
    for spans in by_request.values():
        lo = min(s["device"][0] for s in spans)
        hi = max(s["device"][1] for s in spans)
        total += hi - lo
        idle += hi - lo - _overlap(_busy(spans), lo, hi)
    return (idle, total) if total else None


def tick_idle(sp: Optional[Spanned]) -> Optional[Tuple[int, int]]:
    """(ns of the ticks' host spans outside every chunk's and dispatch's
    device interval, ns of the ticks' host spans); None without device
    intervals."""
    if sp is None:
        return None
    busy = _busy(sp.named("sched.chunk") + sp.named("sched.dispatch"))
    ticks = [(s["t0_ns"], s["t1_ns"]) for s in sp.named("sched.tick")]
    total = sum(b - a for a, b in ticks)
    if not busy or not total:
        return None
    return total - sum(_overlap(busy, a, b) for a, b in ticks), total


def readings(sp: Optional[Spanned]) -> Dict[str, Optional[float]]:
    """What a spanned phase is read for: the median device ms of a token's
    graph replay; the device's idle share (%) of the engine's decode
    loops; the share (%) of the scheduler's ticks outside every chunk's
    and dispatch's device interval; the mean host ms of a prefill chunk's
    program call and of a dispatch's reconcile.  None where the phase has
    nothing to read (the device numbers on the CPU)."""
    dec, tick = decode_idle(sp), tick_idle(sp)
    return {
        "replay_device_ms": median(device_ms(sp, "engine.replay")),
        "decode_idle": None if dec is None else 100.0 * dec[0] / dec[1],
        "tick_idle": None if tick is None else 100.0 * tick[0] / tick[1],
        "chunk_host_ms": mean(host_ms(sp, "sched.chunk")),
        "reconcile_ms": mean(host_ms(sp, "sched.reconcile")),
    }


def idle_by_span(sp: Spanned) -> Tuple[Dict[str, float], int, float]:
    """Device idle seconds in the phase by the innermost span open at each
    gap's middle, and the number and seconds of the gaps too short to
    place."""
    spans = sp.export["spans"]
    lo = int(sp.record.t0 * 1e9)
    hi = max([s["t1_ns"] for s in spans] + [int(sp.record.t1 * 1e9)])
    gaps, cursor = [], lo
    for a, b in _busy(spans):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
    if cursor < hi:
        gaps.append((cursor, hi))
    placed = [g for g in gaps if g[1] - g[0] >= MIN_GAP_NS]
    short = [g for g in gaps if g[1] - g[0] < MIN_GAP_NS]
    host = [(s["t0_ns"], s["t1_ns"], s["name"]) for s in spans]
    host.append((lo, hi, HARNESS))
    return (pb_trace._attribute(placed, host), len(short),
            sum(b - a for a, b in short) * 1e-9)


def line(sp: Spanned) -> str:
    """Each span name's count, host ms, device ms and the device idle ms
    put down to it; the short gaps; the phase's counters and drops."""
    names = sorted({s["name"] for s in sp.export["spans"]})
    dev = sp.has_device()
    idle, n_short, short_s = idle_by_span(sp) if dev else ({}, 0, 0.0)
    parts = []
    for name in names + ([HARNESS] if HARNESS in idle else []):
        host = host_ms(sp, name)
        d = device_ms(sp, name)
        parts.append(f"{name} {len(host)} host {sum(host):.3f} ms dev "
                     + (f"{sum(d):.3f} ms" if d else "-") + " idle "
                     + (f"{1e3 * idle.get(name, 0.0):.3f} ms" if dev else "-"))
    if dev:
        parts.append(f"short gaps {n_short} ({1e3 * short_s:.3f} ms)")
    counters = sp.export["counters"]
    parts.append(", ".join(f"{k} {v}" for k, v in sorted(counters.items()))
                 + f", dropped {sp.export['dropped']}")
    if sp.export.get("end_error_ns") is not None:
        parts.append(f"clocks apart at the end {sp.export['end_error_ns']} ns")
    return "; ".join(parts)
