"""Seeded request-trace generation + SLO metrics for the load harness.

The paper's central claim is that batch-1 decode latency is what the
*session* feels — aggregate tok/s hides launch overhead and runtime
slack because those only surface in per-token latency under realistic
load.  The serving stack's lockstep waves (every benchmark so far)
never exercise that: nothing arrives while the batch is busy, nothing
queues, nothing competes.  This module supplies the missing workload:

  * **Traces**: seeded, fully deterministic request streams with
    Poisson or bursty (on/off modulated) arrivals, mixed prompt/output
    length distributions, and *session classes* — named request
    populations with a priority and per-class SLOs (a TTFT bound and a
    per-token latency bound), e.g. a latency-critical ``interactive``
    class sharing the server with a throughput ``batch`` class.
  * **Replay**: trace requests are plain ``SessionRequest``s carrying
    ``arrival_s``/``priority``/``klass``; ``SlotScheduler`` releases
    them by virtual arrival time against its deterministic clock
    (``virtual_dispatch_s`` launch tax per dispatched program +
    ``virtual_step_s`` per device decode step — the paper's two latency
    terms as an explicit cost model), so queueing/admission/horizon
    policy is measurable machine-independently, while wall-clock TTFT
    rides along when the scheduler is ``timed``.
  * **Metrics**: ``slo_report`` turns per-session token emission stamps
    into TTFT and per-token latency percentiles (p50/p95/p99) and
    **goodput-under-SLO** — generated tokens belonging to sessions that
    met BOTH their class's TTFT and per-token bounds, per virtual
    second of makespan.  Throughput that blows the deadline counts for
    nothing, which is exactly how serving capacity is quoted in
    production and exactly what aggregate tok/s cannot see.

Determinism contract: generation uses ``random.Random`` (whose stream
is stable across Python versions) and serialisation uses fixed float
formatting, so a (config, seed) pair regenerates its trace
byte-for-byte — the golden-trace regression test pins this.

A copy of ``repro.serving.trace`` (framework-neutral: numpy and the
standard library only) that takes ``ContinuousResult`` and
``SessionRequest`` from ``repro_torch.serving.session``; held equal in
behaviour to the original by ``tests/test_torch_serving_copies.py`` and
``tests/test_torch_trace.py``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.session import ContinuousResult, SessionRequest

_FMT = "%.6f"                    # fixed-width times: byte-stable text


@dataclasses.dataclass(frozen=True)
class SessionClass:
    """One request population inside a trace."""
    name: str
    mix: float                   # sampling weight (normalised over classes)
    priority: int = 0            # scheduler preemption priority
    prompt_lo: int = 4           # prompt length range (uniform, inclusive)
    prompt_hi: int = 16
    new_lo: int = 4              # token budget range (uniform, inclusive)
    new_hi: int = 16
    slo_ttft_s: float = 0.5      # virtual-seconds bound on TTFT
    slo_tpot_s: float = 0.05     # virtual-seconds bound on p95 inter-token

    def __post_init__(self):
        assert self.mix > 0 and self.prompt_lo >= 1 and self.new_lo >= 1
        assert self.prompt_hi >= self.prompt_lo
        assert self.new_hi >= self.new_lo
        assert self.slo_ttft_s > 0 and self.slo_tpot_s > 0
        assert " " not in self.name and self.name, "class names are tokens"


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Everything that determines a trace, and nothing else."""
    seed: int = 0
    n_requests: int = 16
    vocab_size: int = 512
    process: str = "poisson"     # "poisson" | "bursty"
    rate_rps: float = 20.0       # mean arrivals per virtual second
    burst_len: int = 4           # bursty: requests per on-burst
    burst_factor: float = 8.0    # bursty: intra-burst rate multiplier
    classes: Tuple[SessionClass, ...] = (
        SessionClass("interactive", mix=0.6, priority=1,
                     prompt_lo=4, prompt_hi=12, new_lo=4, new_hi=10,
                     slo_ttft_s=0.2, slo_tpot_s=0.02),
        SessionClass("batch", mix=0.4, priority=0,
                     prompt_lo=12, prompt_hi=32, new_lo=8, new_hi=24,
                     slo_ttft_s=1.0, slo_tpot_s=0.1),
    )

    def __post_init__(self):
        assert self.process in ("poisson", "bursty"), self.process
        assert self.n_requests >= 1 and self.vocab_size >= 2
        assert self.rate_rps > 0 and self.burst_len >= 1
        assert self.burst_factor >= 1.0
        assert self.classes
        names = [c.name for c in self.classes]
        assert len(set(names)) == len(names), "duplicate class names"


@dataclasses.dataclass(frozen=True)
class Trace:
    config: TraceConfig
    requests: Tuple[SessionRequest, ...]

    @property
    def classes(self) -> Dict[str, SessionClass]:
        return {c.name: c for c in self.config.classes}

    def max_len(self) -> int:
        """Smallest cache ``max_len`` that fits every session (last
        decode write lands at S + new - 2)."""
        return max(len(r.prompt) + r.max_new_tokens for r in self.requests)


def _exp(r: random.Random, rate: float) -> float:
    """Inverse-transform exponential gap — ``random.Random.random`` is
    version-stable, unlike library distribution helpers."""
    return -math.log(1.0 - r.random()) / rate


def generate_trace(cfg: TraceConfig) -> Trace:
    """Deterministically expand a config into a request stream.

    Poisson: i.i.d. exponential inter-arrival gaps at ``rate_rps``.
    Bursty: on/off modulation — bursts of ``burst_len`` requests whose
    intra-burst gaps run at ``rate_rps * burst_factor``, separated by
    off-gaps sized so the long-run mean rate stays ``rate_rps`` (the
    same offered load, maximally unfriendly arrangement — what an
    admission policy actually has to survive)."""
    r = random.Random(cfg.seed)
    weights = [c.mix for c in cfg.classes]
    total_w = sum(weights)
    reqs: List[SessionRequest] = []
    t = 0.0
    for i in range(cfg.n_requests):
        if cfg.process == "poisson":
            t += _exp(r, cfg.rate_rps)
        else:
            hi = cfg.rate_rps * cfg.burst_factor
            if i and i % cfg.burst_len == 0:
                # off-gap: the burst's saved time plus a fresh mean gap,
                # so bursts cluster without raising the offered load
                t += _exp(r, cfg.rate_rps / cfg.burst_len) \
                    + _exp(r, cfg.rate_rps)
            else:
                t += _exp(r, hi)
        # class choice by cumulative weight
        u = r.random() * total_w
        klass = cfg.classes[-1]
        for c in cfg.classes:
            if u < c.mix:
                klass = c
                break
            u -= c.mix
        plen = r.randrange(klass.prompt_lo, klass.prompt_hi + 1)
        n_new = r.randrange(klass.new_lo, klass.new_hi + 1)
        prompt = np.asarray([r.randrange(cfg.vocab_size)
                             for _ in range(plen)], np.int32)
        reqs.append(SessionRequest(
            session_id=f"t{i:03d}", prompt=prompt, max_new_tokens=n_new,
            arrival_s=t, priority=klass.priority, klass=klass.name))
    trace = Trace(cfg, tuple(reqs))
    validate_trace(trace)
    return trace


def validate_trace(trace: Trace) -> None:
    """Schema validity: unique session ids, positive monotone arrivals,
    positive lengths, known class labels, in-vocab tokens.  Raises
    ``ValueError`` with the offending session named (explicit raises,
    not asserts — a hand-edited trace file must fail loudly even under
    ``python -O``; the golden-trace test runs this on the checked-in
    file too)."""
    def bad(msg: str) -> None:
        raise ValueError(f"invalid trace: {msg}")

    classes = trace.classes
    seen: set = set()
    last = 0.0
    for req in trace.requests:
        if req.session_id in seen:
            bad(f"duplicate session id {req.session_id!r} — replay "
                f"results key sessions by id, duplicates would collide")
        seen.add(req.session_id)
        if req.arrival_s <= 0:
            bad(f"{req.session_id}: arrival_s={req.arrival_s!r} must be "
                f"> 0 (non-positive arrivals bypass trace release)")
        if req.arrival_s < last:
            bad(f"{req.session_id}: arrivals must be monotone "
                f"({req.arrival_s!r} after {last!r})")
        last = req.arrival_s
        if len(req.prompt) < 1:
            bad(f"{req.session_id}: empty prompt")
        if req.max_new_tokens < 1:
            bad(f"{req.session_id}: no token budget")
        if req.klass not in classes:
            bad(f"{req.session_id}: unknown class {req.klass!r}")
        if req.priority != classes[req.klass].priority:
            bad(f"{req.session_id}: priority disagrees with its class")
        toks = np.asarray(req.prompt)
        if toks.min() < 0 or toks.max() >= trace.config.vocab_size:
            bad(f"{req.session_id}: token out of vocab")


# --------------------------------------------------------------- text I/O
def trace_to_text(trace: Trace) -> str:
    """Serialise byte-stably: a header line pinning the config, one
    ``class`` line per session class, one request line per arrival with
    the prompt tokens inline (the trace IS the workload — no hidden
    regeneration step between a saved trace and its replay)."""
    cfg = trace.config
    lines = [
        "# trace v1 seed=%d n=%d vocab=%d process=%s rate=%s "
        "burst_len=%d burst_factor=%s"
        % (cfg.seed, cfg.n_requests, cfg.vocab_size, cfg.process,
           _FMT % cfg.rate_rps, cfg.burst_len, _FMT % cfg.burst_factor)]
    for c in cfg.classes:
        lines.append(
            "# class %s mix=%s prio=%d prompt=%d:%d new=%d:%d "
            "slo_ttft=%s slo_tpot=%s"
            % (c.name, _FMT % c.mix, c.priority, c.prompt_lo, c.prompt_hi,
               c.new_lo, c.new_hi, _FMT % c.slo_ttft_s,
               _FMT % c.slo_tpot_s))
    for r in trace.requests:
        toks = ",".join(str(int(t)) for t in np.asarray(r.prompt))
        lines.append("%s t=%s class=%s prio=%d new=%d prompt=%s"
                     % (r.session_id, _FMT % r.arrival_s, r.klass,
                        r.priority, r.max_new_tokens, toks))
    return "\n".join(lines) + "\n"


def trace_from_text(text: str) -> Trace:
    """Parse ``trace_to_text`` output back into a Trace (validated)."""
    header: Optional[dict] = None
    classes: List[SessionClass] = []
    reqs: List[SessionRequest] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        if parts[0] == "#" and parts[1] == "trace":
            assert parts[2] == "v1", f"unknown trace version {parts[2]}"
            kv = dict(p.split("=", 1) for p in parts[3:])
            header = kv
        elif parts[0] == "#" and parts[1] == "class":
            kv = dict(p.split("=", 1) for p in parts[3:])
            plo, phi = kv["prompt"].split(":")
            nlo, nhi = kv["new"].split(":")
            classes.append(SessionClass(
                parts[2], mix=float(kv["mix"]), priority=int(kv["prio"]),
                prompt_lo=int(plo), prompt_hi=int(phi),
                new_lo=int(nlo), new_hi=int(nhi),
                slo_ttft_s=float(kv["slo_ttft"]),
                slo_tpot_s=float(kv["slo_tpot"])))
        else:
            kv = dict(p.split("=", 1) for p in parts[1:])
            prompt = np.asarray([int(t) for t in kv["prompt"].split(",")],
                                np.int32)
            reqs.append(SessionRequest(
                session_id=parts[0], prompt=prompt,
                max_new_tokens=int(kv["new"]), arrival_s=float(kv["t"]),
                priority=int(kv["prio"]), klass=kv["class"]))
    assert header is not None, "missing trace header"
    cfg = TraceConfig(
        seed=int(header["seed"]), n_requests=int(header["n"]),
        vocab_size=int(header["vocab"]), process=header["process"],
        rate_rps=float(header["rate"]), burst_len=int(header["burst_len"]),
        burst_factor=float(header["burst_factor"]),
        classes=tuple(classes))
    trace = Trace(cfg, tuple(reqs))
    validate_trace(trace)
    return trace


# ----------------------------------------------------------- SLO metrics
def _percentiles(xs: Sequence[float]) -> Dict[str, float]:
    a = np.asarray(xs, float)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


def session_meets_slo(sess, klass: SessionClass) -> bool:
    """TTFT within bound AND p95 of the per-token latency stream within
    bound (1-token sessions have no inter-token stream and pass that
    half trivially)."""
    if sess.ttft_s is None or sess.ttft_s > klass.slo_ttft_s:
        return False
    lat = sess.token_latencies_s()
    return lat.size == 0 or \
        float(np.percentile(lat, 95)) <= klass.slo_tpot_s


def slo_report(result: ContinuousResult,
               classes: Mapping[str, SessionClass],
               skip_prefix: str = "warm_") -> dict:
    """Aggregate + per-class SLO metrics of a replayed trace.

    Latencies are *virtual* (the scheduler's deterministic clock), so
    the numbers are machine-independent and byte-reproducible; wall
    TTFT percentiles ride along when the run was timed.  JSON-safe by
    construction: every value is a finite float, int, bool or None —
    never NaN (``json.dumps(report, allow_nan=False)`` must succeed,
    which the latency-field tests pin for timed and untimed runs)."""
    pool = [s for s in result.sessions.values()
            if not s.session_id.startswith(skip_prefix)]
    failed = [s for s in pool if s.status != "ok"]
    sessions = [s for s in pool
                if s.status == "ok" and s.token_times_s.size]
    n_total = len(sessions) + len(failed)
    statuses: dict = {}
    for s in failed:
        statuses[s.status] = statuses.get(s.status, 0) + 1
    # non-ok sessions (aborted / failed / expired) never enter the
    # latency percentile streams — a truncated stream's TPOT would
    # flatter the tail — but they stay in every SLO denominator: a
    # dropped session is a missed SLO, and its tokens are not goodput
    report: dict = {"sessions": n_total, "classes": {},
                    "failed_sessions": len(failed),
                    "statuses": dict(sorted(statuses.items()))}
    if not sessions:
        report.update(ttft=None, tpot=None, goodput_tok_s=0.0,
                      slo_sessions=0, makespan_s=0.0)
        if failed:
            report["slo_frac"] = 0.0
        return report
    t0 = min(s.arrival_s for s in sessions)
    t1 = max(float(s.token_times_s[-1]) for s in sessions)
    makespan = max(t1 - t0, 1e-12)
    all_lat = [lat for s in sessions
               for lat in s.token_latencies_s().tolist()]
    walls = [s.ttft_wall_s for s in sessions if s.ttft_wall_s is not None]
    ok_sessions = [s for s in sessions
                   if s.klass in classes
                   and session_meets_slo(s, classes[s.klass])]
    good_tokens = sum(len(s.tokens) for s in ok_sessions)
    report.update(
        ttft=_percentiles([s.ttft_s for s in sessions]),
        tpot=_percentiles(all_lat) if all_lat else None,
        ttft_wall=_percentiles(walls) if walls else None,
        slo_sessions=len(ok_sessions),
        slo_frac=len(ok_sessions) / n_total,
        goodput_tok_s=good_tokens / makespan,
        tokens_per_s_virtual=sum(len(s.tokens)
                                 for s in sessions) / makespan,
        makespan_s=makespan)
    for name, klass in classes.items():
        cs = [s for s in sessions if s.klass == name]
        cf = [s for s in failed if s.klass == name]
        if not cs and not cf:
            continue
        c_lat = [lat for s in cs for lat in s.token_latencies_s().tolist()]
        c_ok = [s for s in cs if session_meets_slo(s, klass)]
        report["classes"][name] = {
            "sessions": len(cs) + len(cf),
            "failed_sessions": len(cf),
            "priority": klass.priority,
            "ttft": _percentiles([s.ttft_s for s in cs]) if cs else None,
            "tpot": _percentiles(c_lat) if c_lat else None,
            "slo_ttft_s": klass.slo_ttft_s,
            "slo_tpot_s": klass.slo_tpot_s,
            "slo_frac": len(c_ok) / (len(cs) + len(cf)),
            "goodput_tok_s": sum(len(s.tokens) for s in c_ok) / makespan,
        }
    return report


# ------------------------------------------------------- canned configs
def poisson_config(seed: int = 0, n_requests: int = 16,
                   vocab_size: int = 512, rate_rps: float = 20.0,
                   classes: Optional[Tuple[SessionClass, ...]] = None
                   ) -> TraceConfig:
    kw = {} if classes is None else {"classes": classes}
    return TraceConfig(seed=seed, n_requests=n_requests,
                       vocab_size=vocab_size, process="poisson",
                       rate_rps=rate_rps, **kw)


def bursty_config(seed: int = 0, n_requests: int = 16,
                  vocab_size: int = 512, rate_rps: float = 20.0,
                  burst_len: int = 4, burst_factor: float = 8.0,
                  classes: Optional[Tuple[SessionClass, ...]] = None
                  ) -> TraceConfig:
    kw = {} if classes is None else {"classes": classes}
    return TraceConfig(seed=seed, n_requests=n_requests,
                       vocab_size=vocab_size, process="bursty",
                       rate_rps=rate_rps, burst_len=burst_len,
                       burst_factor=burst_factor, **kw)
