"""The drivers: they send a traffic file's requests to the port and stamp
every delivery on the host clock.

``engine_stream``: batch-1 requests, one at a time, through
``DecodeEngine.generate_streamed(timed=True)``: one graph replay per
token, and a synchronize after each, whose time the engine records.  A
token's delivery is that synchronize: the stamps are taken back from the
moment the call returns, step by step.  Keys: ``max_len``,
``warmup_requests`` (served in the set-up, at the window's sizes: the
decode graph is captured there, and some ten seconds of them leave the
allocator with every block the window asks for and the pace steady),
``trace_requests`` (served under the profiler after the window).

``scheduler``: every request through one ``SlotScheduler`` (its
keyword arguments under ``scheduler``), driven here by ``submit`` and
``tick``.  A tick's tokens are delivered when the tick returns; a
horizon-K tick delivers once.  Keys: ``max_len``, ``scheduler``,
``ramp_ticks`` (ticks of the loop run in the set-up, so that the window
starts in the steady state), ``trace_ticks`` (ticks under the profiler
after the window).

Each driver keeps, on the host clock, every request, every device
decode step (the live lengths of its lanes after its write; () for a
step that ran with every lane masked), every prefill piece and every
scheduler dispatch; the metrics pick the window's.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from pb_traffic import Traffic

FAILED = ("failed", "aborted", "expired")


@dataclasses.dataclass
class Req:
    index: int
    prompt_len: int
    budget: int
    sent: float                     # when sent (an open loop: when due)
    deliveries: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = "open"            # "open" | "ok" | a scheduler failure kind


@dataclasses.dataclass
class Record:
    """A span of the host clock, [t0, t1], over what the driver kept."""
    t0: float
    t1: float
    requests: List[Req]
    steps: List[Tuple[float, Tuple[int, ...]]]
    prefills: List[Tuple[float, int, int]]        # (stamp, start, length)
    dispatches: List[Tuple[float, int, float]]    # (stamp, steps, host s)

    def within(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


class _Driver:
    def __init__(self, spec: Mapping, seed: int, vocab: int):
        self.spec = spec
        self.traffic = Traffic(spec, seed, vocab)
        self.requests: List[Req] = []
        self.steps: List[Tuple[float, Tuple[int, ...]]] = []
        self.prefills: List[Tuple[float, int, int]] = []
        self.dispatches: List[Tuple[float, int, float]] = []
        self._base: Optional[float] = None    # open loops: the first due time

    def record(self, t0: float, t1: float) -> Record:
        return Record(t0, t1, self.requests, self.steps, self.prefills,
                      self.dispatches)

    def _new_request(self, sent: float) -> Tuple[Req, np.ndarray]:
        i = len(self.requests)
        r = self.traffic.request(i)
        req = Req(i, r.prompt_len, r.new_tokens, sent)
        self.requests.append(req)
        return req, self.traffic.prompt(i)

    def _due_abs(self, i: int) -> Optional[float]:
        """Open loops: when request i is due on the host clock.  The
        schedule starts anew with each phase (warm-up, window, traced
        window): its first request is due when it begins."""
        due = self.traffic.due(i)
        if due is None:
            return None
        if self._base is None:
            self._base = time.perf_counter() - due
        return self._base + due

    def window(self, seconds: float) -> Record:
        self._base = None
        t0 = time.perf_counter()
        t1 = t0 + seconds
        self._run_until(lambda: time.perf_counter() >= t1)
        return self.record(t0, t1)


class EngineDriver(_Driver):
    """Batch-1 requests through ``DecodeEngine.generate_streamed``."""

    def __init__(self, model, params, spec: Mapping, seed: int):
        from repro_torch.serving.engine import DecodeEngine
        super().__init__(spec, seed, model.cfg.vocab_size)
        if self.traffic.kind == "closed" and self.traffic.clients != 1:
            raise ValueError("engine_stream serves one client at a time")
        self.engine = DecodeEngine(model, params)
        self.device = model.device

    def _serve_one(self) -> None:
        due = self._due_abs(len(self.requests))
        if due is not None:
            time.sleep(max(0.0, due - time.perf_counter()))
        req, prompt = self._new_request(due if due is not None
                                        else time.perf_counter())
        batch = {"tokens": torch.from_numpy(prompt)[None].to(self.device)}
        res = self.engine.generate_streamed(
            batch, max_len=int(self.spec["max_len"]), n_new=req.budget,
            timed=True)
        t_ret = time.perf_counter()
        stamps = [t_ret]
        for dt in reversed(res.step_times_s):
            stamps.append(stamps[-1] - dt)
        stamps.reverse()
        req.tokens = res.tokens[0].tolist()
        req.deliveries = [(t, 1) for t in stamps]
        req.status = "ok"
        P = req.prompt_len
        self.prefills.append((stamps[0], 0, P))
        self.steps.extend((stamps[k], (P + k,)) for k in range(1, len(stamps)))

    def _run_until(self, done) -> None:
        while not done():
            self._serve_one()

    def warm(self) -> None:
        for _ in range(int(self.spec.get("warmup_requests", 1))):
            self._serve_one()

    def traced(self) -> Record:
        self._base = None
        t0 = time.perf_counter()
        for _ in range(int(self.spec["trace_requests"])):
            self._serve_one()
        return self.record(t0, time.perf_counter())

    def finish(self, record: Record) -> None:
        """Every request is whole when its call returns."""

    def close(self) -> None:
        del self.engine


class SchedulerDriver(_Driver):
    """Every request through one ``SlotScheduler``'s ``submit`` / ``tick``."""

    def __init__(self, model, params, spec: Mapping, seed: int):
        from repro_torch.serving.scheduler import SlotScheduler
        from repro_torch.serving.session import SessionRequest
        super().__init__(spec, seed, model.cfg.vocab_size)
        self._session_request = SessionRequest
        self.sched = SlotScheduler(model, params, max_len=int(spec["max_len"]),
                                   seed=seed,
                                   timed=False, **spec["scheduler"])
        self.live: Dict[str, Req] = {}
        self.idle_clients = self.traffic.clients
        self.sending = True

    def _send(self, sent: float) -> None:
        req, prompt = self._new_request(sent)
        self.sched.submit(self._session_request(
            session_id=str(req.index), prompt=prompt,
            max_new_tokens=req.budget))
        self.live[str(req.index)] = req

    def _prefilling(self) -> Dict[str, int]:
        return {s.sid: s.prefilled for s in self.sched.slots
                if s is not None and not s.decoding}

    def _tick(self) -> None:
        sched = self.sched
        if self.sending:
            if self.traffic.kind == "closed":
                while self.idle_clients:
                    self.idle_clients -= 1
                    self._send(time.perf_counter())
            else:
                while True:
                    due = self._due_abs(len(self.requests))
                    if due > time.perf_counter():
                        break
                    self._send(due)
        before = self._prefilling()
        held = {sid: len(req.tokens) for sid, req in self.live.items()}
        n_disp, host_s = sched.decode_steps, sched.host_dispatch_s
        hist = collections.Counter(sched.horizon_hist)
        events = sched.tick()
        t = time.perf_counter()
        got: Dict[str, int] = collections.Counter()
        ended = []
        for ev in events:
            if ev[0] == "token":
                self.live[ev[1]].tokens.append(int(ev[3]))
                got[ev[1]] += 1
            elif ev[0] == "finish" or ev[0] in FAILED:
                ended.append((ev[1], "ok" if ev[0] == "finish" else ev[0]))
        for sid, n in got.items():
            self.live[sid].deliveries.append((t, n))
        # prefill pieces: what each session in prefill wrote this tick
        after = self._prefilling()
        for sid, req in self.live.items():
            start = before.get(sid, 0)
            if sid in after:
                end = after[sid]
            elif sid in before or (held[sid] == 0 and got.get(sid)):
                end = req.prompt_len
            else:
                continue
            if end > start:
                self.prefills.append((t, start, end - start))
        # device decode steps: the lanes live at each step of the dispatch
        if sched.decode_steps > n_disp:
            new = collections.Counter(sched.horizon_hist) - hist
            k = max(new) if new else 1         # a K=1 tick keeps no histogram
            self.dispatches.append((t, k, sched.host_dispatch_s - host_s))
            lanes = []
            for sid, n in got.items():
                first = held[sid] == 0
                decoded = n - first
                if decoded:
                    lanes.append((self.live[sid].prompt_len + held[sid] + first,
                                  decoded))
            for j in range(k):
                self.steps.append((t, tuple(base + j for base, d in lanes
                                            if d > j)))
        for sid, status in ended:
            req = self.live.pop(sid)
            req.status = status
            if self.traffic.kind == "closed":
                self.idle_clients += 1

    def _run_until(self, done) -> None:
        while not done():
            self._tick()

    def warm(self) -> None:
        for _ in range(int(self.spec["ramp_ticks"])):
            self._tick()

    def traced(self) -> Record:
        self._base = None
        t0 = time.perf_counter()
        for _ in range(int(self.spec["trace_ticks"])):
            self._tick()
        return self.record(t0, time.perf_counter())

    def finish(self, record: Record) -> None:
        """Tick on, sending nothing new, until every request sent in the
        window has its first token (for the time to first token)."""
        self.sending = False
        waiting = [r for r in self.requests
                   if record.within(r.sent) and not r.deliveries
                   and r.status == "open"]
        while any(not r.deliveries and r.status == "open" for r in waiting):
            self._tick()

    def close(self) -> None:
        del self.sched


DRIVERS = {"engine_stream": EngineDriver, "scheduler": SchedulerDriver}
