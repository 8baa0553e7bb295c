"""What the profiler saw in the traced window.

The traced window is the span of the benchmark's own ``pb.traced``
annotation.  The device was busy where a kernel, a copy or a memset ran:
the union of those intervals, so overlapping work counts once.  Each gap
in that union is put down to what the host was doing at its middle: the
innermost host event open there (an operator, a runtime call such as the
synchronize that waits on a graph replay, or one of the benchmark's own
spans).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

SPAN = "pb.traced"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]     # name -> (launches, seconds)
    idle: Dict[str, float]                    # host activity -> idle seconds

    def launches(self, part: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds ``part``."""
        n = t = 0
        for name, (k, s) in self.kernels.items():
            if part in name:
                n, t = n + k, t + s
        return n, t

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:120], s] for name, (_, s) in top],
                "idle_gaps": [[name[:120], s] for name, s in gaps]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(prof) -> TraceSummary:
    """Read a stopped ``torch.profiler.profile`` over one ``pb.traced`` span."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    span = None
    host: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str]] = []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == SPAN:
                span = (a, b)
            else:
                host.append((a, b, e.name()))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            # (a user annotation is a record_function range mirrored there)
            device.append((a, b, e.name()))
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    lo, hi = span
    kernels: Dict[str, List] = collections.defaultdict(lambda: [0, 0.0])
    inside = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        inside.append((a, b))
        kernels[name][0] += 1
        kernels[name][1] += (b - a) * 1e-9
    busy = _union(inside)
    gaps = []
    cursor = lo
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = b
    if cursor < hi:
        gaps.append((cursor, hi))
    return TraceSummary(window_s=(hi - lo) * 1e-9,
                        busy_s=sum(b - a for a, b in busy) * 1e-9,
                        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                        idle=_attribute(gaps, host))


def _attribute(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's middle."""
    host = sorted(host)
    idle: Dict[str, float] = collections.defaultdict(float)
    active: List[Tuple[int, int, str]] = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active)[2] if active else "host: Python between operators"
        idle[name] += (b - a) * 1e-9
    return dict(idle)
