"""Arithmetic the metric readers share: what the window's deliveries,
steps and prefills add up to, and the traced window's kernel shares.

A metric reader (``perfbench/metrics/<name>.py``) gets a ``Run`` and
returns a number, or None where the run holds nothing to read; the
harness then leaves the metric out.

The window is [t0, t1] on the host clock.  A request belongs to it when
it was sent (an open loop: due) inside it; a delivery, a decode step or
a prefill piece when its stamp lies inside it.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Mapping, Optional, Tuple

import numpy as np

import pb_counts
from pb_drive import Record, Req
from pb_trace import TraceSummary


@dataclasses.dataclass
class Run:
    cell: str
    config: Mapping
    traffic: Mapping
    shape: pb_counts.Shape
    setup_s: float
    window: Record
    traced: Optional[Record] = None
    trace: Optional[TraceSummary] = None


def window_requests(rec: Record) -> List[Req]:
    return [r for r in rec.requests if rec.within(r.sent)]


def ttfts_s(rec: Record) -> List[float]:
    return [r.deliveries[0][0] - r.sent for r in window_requests(rec)
            if r.deliveries]


def decode_gaps_s(rec: Record) -> List[float]:
    """Each delivery in the window after a request's first: the time since
    that request's previous delivery."""
    return [d[k][0] - d[k - 1][0] for d in (r.deliveries for r in rec.requests)
            for k in range(1, len(d)) if rec.within(d[k][0])]


def tpot_s(rec: Record) -> Optional[float]:
    """Sum over requests of (last delivery - first) over the sum of their
    tokens after the first, counting what was delivered in the window; a
    request begun before the window counts from its last delivery before
    it."""
    span = tokens = 0.0
    for r in rec.requests:
        idx = [k for k, (t, _) in enumerate(r.deliveries) if rec.within(t)]
        if not idx:
            continue
        n = sum(r.deliveries[k][1] for k in idx)
        first = idx[0]
        if first == 0:
            n -= 1
        else:
            first -= 1
        span += r.deliveries[idx[-1]][0] - r.deliveries[first][0]
        tokens += n
    return span / tokens if tokens else None


def tokens_delivered(rec: Record) -> int:
    return sum(n for r in rec.requests for t, n in r.deliveries
               if rec.within(t))


def steps_in(rec: Record) -> List[Tuple[int, ...]]:
    """The live lengths of every device decode step stamped in the span
    (() for a step with every lane masked)."""
    return [lens for t, lens in rec.steps if rec.within(t)]


def decode_least_s(run: Run, rec: Record) -> float:
    return sum(pb_counts.least_time(*pb_counts.decode_step(run.shape, lens))
               for lens in steps_in(rec) if lens)


def prefill_least_s(run: Run, rec: Record) -> float:
    return sum(pb_counts.least_time(*pb_counts.prefill(run.shape, start, n))
               for t, start, n in rec.prefills if rec.within(t))


def kernel_roofline(run: Run, kernel: str, per_step_bytes) -> Optional[float]:
    """A kernel's share of its roofline over the traced window: the bytes
    its launches needed over the peak bandwidth, over their device time.
    ``per_step_bytes(lens)`` is one layer's launch at a device step; the
    kernel runs once a layer at every device step of the span."""
    if run.trace is None or run.traced is None:
        return None
    steps = steps_in(run.traced)
    launches, seconds = run.trace.launches(kernel)
    if not launches:
        return None
    expected = run.shape.layers * len(steps)
    if launches != expected:
        print(f"{kernel}: {launches} launches traced, {expected} expected "
              f"({len(steps)} device steps); its roofline is left out",
              file=sys.stderr)
        return None
    need = sum(per_step_bytes(lens) for lens in steps) * run.shape.layers
    return 100.0 * need / pb_counts.PEAK_BYTES / seconds


def p95(xs: List[float]) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), 95)) if xs else None


def thirds(rec: Record) -> str:
    """Time per output token and the p95 gap in each third of the window,
    in ms, and the slowest first token: whether a run drifts or stalls."""
    span = (rec.t1 - rec.t0) / 3
    parts = []
    for k in range(3):
        sub = dataclasses.replace(rec, t0=rec.t0 + k * span,
                                  t1=rec.t0 + (k + 1) * span)
        t, p = tpot_s(sub), p95(decode_gaps_s(sub))
        parts.append(f"{1e3 * t:.4f}/{1e3 * p:.4f}" if t and p else "-")
    worst = max(window_requests(rec), default=None,
                key=lambda r: r.deliveries[0][0] - r.sent if r.deliveries else 0)
    slow = (f"; slowest first token {1e3 * (worst.deliveries[0][0] - worst.sent):.2f}"
            f" ms, request {worst.index}" if worst and worst.deliveries else "")
    return "tpot/p95 ms by third " + " ".join(parts) + slow
