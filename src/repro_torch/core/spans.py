"""Spans, counters and device intervals recorded inside the port.

One recorder, off by default.  ``with spans.recording(device) as rec:``
turns it on for the block; ``rec.export()`` afterwards returns what it
kept as plain data, and ``rec.chrome_trace(path)`` writes it as a Chrome
trace (for Perfetto).  The engine (``serving/engine.py``) and the
scheduler (``serving/scheduler.py``) open and close spans at their layer
boundaries; ``core/dispatch.py`` counts graph captures.

- A **span** has a name, a start and an end on ``time.perf_counter_ns()``,
  an id (its index), the id of its parent (-1 for none), a request id
  shared by the spans of one request (the engine's call number, a
  scheduler session's id) and, optionally, counts of the work it did.
- A span over work enqueued on the card also has a **device interval**:
  a pair of ``torch.cuda.Event(enable_timing=True)`` records on the
  current stream, from a pool made (and each event created, by one
  record) when the recorder is turned on.  A span past the recorder's
  ``capacity`` is dropped, and the drop counted; nothing is created in a
  hot loop.
- **One clock.**  Turned on, the recorder synchronises, records an anchor
  event and stamps the host clock right after it.  An event maps to the
  host clock as ``anchor_ns + anchor.elapsed_time(event) * 1e6``, so host
  spans and device intervals lie on one timeline.  The two clocks drift
  apart by a few parts per million (~60 µs in 30 s on an H100), so
  ``export`` takes a second anchor the same way and stretches the device
  clock to meet it.  Nothing in a hot path queries or synchronises an
  event: ``export`` reads them after one synchronize.
- **Profiler ranges.**  Turned on while a ``torch.profiler`` session runs,
  the recorder also opens a ``record_function`` range for each span, so
  the profiler's trace carries the port's span names.
- **Off**, a site costs one test: it fetches ``recorder()`` once a call (a
  request, a tick) and tests it for None.

Counters: ``graph_captures`` (``core/dispatch.capture``) and, at export,
``kernel_builds`` (the libraries ``kernels/_build`` built while the
recorder was on).  The scheduler's per-tick counts ride on its spans.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Dict, Iterator, List, Optional

import torch

# the recorder that is on, or None
_active: Optional["Recorder"] = None

NAME, PARENT, REQUEST, T0, T1, EV0, EV1, COUNTS, RANGE = range(9)


def recorder() -> Optional["Recorder"]:
    """The recorder that is on, or None."""
    return _active


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recorder that is on."""
    rec = _active
    if rec is not None:
        rec.counters[name] += n


class Recorder:
    """What one ``recording()`` block kept."""

    def __init__(self, device: torch.device, capacity: int):
        self.device = device
        self.capacity = capacity
        self.counters: Dict[str, int] = collections.Counter()
        self.dropped = 0
        self._spans: List[list] = []
        self._ranges = torch._C._autograd._profiler_enabled()
        from repro_torch.kernels import _build
        self._builds = dict(_build.build_seconds)
        self._events: Optional[list] = None
        self._next = 0
        self._scale = 1.0       # host ns a device ns, from the two anchors
        self.anchor_ns = time.perf_counter_ns()
        if device.type == "cuda":
            # two events a span and the two anchors, each created by one
            # record here
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2 * capacity + 2)]
            with torch.cuda.device(device):
                for e in events:
                    e.record()
                torch.cuda.synchronize(device)
                self._end = events.pop()
                self._anchor = events.pop()
                self._anchor.record()
                self.anchor_ns = time.perf_counter_ns()
            self._events = events

    def _mark(self) -> int:
        i = self._next
        self._next = i + 1
        self._events[i].record()
        return i

    def open(self, name: str, parent: int = -1, request=None, *,
             device: bool = False, t: Optional[int] = None) -> int:
        """Start a span (at ``t``, a ``perf_counter_ns`` stamp the caller
        took, else now) and return its id, or -1 when the recorder is
        full.  ``device``: record the start of a device interval on the
        current stream."""
        if len(self._spans) >= self.capacity:
            self.dropped += 1
            return -1
        if t is None:
            t = time.perf_counter_ns()
        ev = self._mark() if device and self._events is not None else None
        rng = None
        if self._ranges:
            rng = torch.profiler.record_function(name)
            rng.__enter__()
        self._spans.append([name, parent, request, t, None, ev, None, None,
                            rng])
        return len(self._spans) - 1

    def close(self, sid: int, *, t: Optional[int] = None,
              counts: Optional[dict] = None) -> None:
        """End span ``sid`` (at ``t``, else now), with its ``counts``."""
        if sid < 0:
            return
        s = self._spans[sid]
        if s[EV0] is not None:
            s[EV1] = self._mark()
        s[T1] = time.perf_counter_ns() if t is None else t
        if counts:
            s[COUNTS] = counts
        if s[RANGE] is not None:
            s[RANGE].__exit__(None, None, None)
            s[RANGE] = None

    def _host_ns(self, event) -> int:
        return self.anchor_ns + round(
            self._anchor.elapsed_time(event) * 1e6 * self._scale)

    def export(self) -> dict:
        """Everything kept, as plain data: ``spans`` (each a dict: ``id``,
        ``name``, ``parent``, ``request``, ``t0_ns``, ``t1_ns``,
        ``device`` [start, end] in host ns or None, ``counts``; spans not
        closed are left out), ``counters``, ``dropped`` (spans past the
        capacity), ``anchor_ns`` and, on the card, ``end_error_ns``: the
        second anchor, an event recorded after a synchronize at export,
        mapped through the first alone, less the host stamp taken after
        it (how far the clocks drifted apart over the recording, give or
        take the anchor's error), which the mapping then takes out."""
        end_error = None
        if self._events is not None:
            torch.cuda.synchronize(self.device)
            self._end.record()
            t_end = time.perf_counter_ns()
            torch.cuda.synchronize(self.device)
            device_ns = self._anchor.elapsed_time(self._end) * 1e6
            end_error = self.anchor_ns + round(device_ns) - t_end
            self._scale = (t_end - self.anchor_ns) / device_ns
        from repro_torch.kernels import _build
        counters = dict(self.counters)
        counters["kernel_builds"] = sum(
            1 for n, s in _build.build_seconds.items()
            if s > 0 and self._builds.get(n) != s)
        counters.setdefault("graph_captures", 0)
        spans = []
        for sid, s in enumerate(self._spans):
            if s[T1] is None:
                continue
            dev = None
            if s[EV1] is not None:
                a = self._host_ns(self._events[s[EV0]])
                dev = [a, a + round(self._events[s[EV0]].elapsed_time(
                    self._events[s[EV1]]) * 1e6 * self._scale)]
            spans.append({"id": sid, "name": s[NAME], "parent": s[PARENT],
                          "request": s[REQUEST], "t0_ns": s[T0],
                          "t1_ns": s[T1], "device": dev,
                          "counts": s[COUNTS] or {}})
        return {"spans": spans, "counters": counters, "dropped": self.dropped,
                "anchor_ns": self.anchor_ns, "end_error_ns": end_error}

    def chrome_trace(self, path: str) -> int:
        """Write ``export()`` as Chrome-trace JSON: host spans on one
        track, device intervals on another, times from the anchor.
        Returns the number of spans written."""
        data = self.export()
        base = data["anchor_ns"]
        events = [{"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                   "args": {"name": name}}
                  for tid, name in ((0, "host"), (1, "device"))]
        for s in data["spans"]:
            args = {"id": s["id"], "parent": s["parent"],
                    "request": s["request"], **s["counts"]}
            for tid, (a, b) in ((0, (s["t0_ns"], s["t1_ns"])),
                                (1, s["device"] or (None, None))):
                if a is not None:
                    events.append({"ph": "X", "pid": 0, "tid": tid,
                                   "name": s["name"], "ts": (a - base) / 1e3,
                                   "dur": (b - a) / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counters": data["counters"],
                                     "dropped": data["dropped"]}}, f)
        return len(data["spans"])


@contextlib.contextmanager
def recording(device=None, *, capacity: int = 1 << 14) -> Iterator[Recorder]:
    """Turn the recorder on for the block (on ``device``: the card when
    there is one, else the CPU, where spans have no device interval)."""
    global _active
    if _active is not None:
        raise RuntimeError("a recorder is already on")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    rec = Recorder(torch.device(device), capacity)
    _active = rec
    try:
        yield rec
    finally:
        _active = None


def anchor_errors(device, n: int = 1000) -> List[int]:
    """The anchor's error, ns: ``n`` times, an event recorded right after
    a synchronize, mapped to the host clock through a recorder's anchor,
    less the host stamp taken right after the record."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    stamps = []
    with recording(device, capacity=0) as rec:
        for e in events:
            e.record()
        for e in events:
            torch.cuda.synchronize(device)
            e.record()
            stamps.append(time.perf_counter_ns())
        torch.cuda.synchronize(device)
        return [rec._host_ns(e) - t for e, t in zip(events, stamps)]
