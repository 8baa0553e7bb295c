"""Session-facing dataclasses of the continuous-batching scheduler.

A copy of ``repro.serving.session`` (framework-neutral: numpy only),
held equal in behaviour to it by ``tests/test_torch_serving_copies.py``.
Every field is kept, the host-tier and fault counters included, and
the port's scheduler fills them as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Event = Tuple
# ("admit"|"token"|"finish"|"preempt", session_id, slot[, token]) plus
# the fault/recovery kinds: "pressure"|"corrupt"|"degraded"|
# "quarantine"|"audit" and the terminal "aborted"|"failed"|"expired"


@dataclasses.dataclass(frozen=True)
class SessionRequest:
    """One user session: a prompt, a token budget, and (for trace
    replay) an arrival time plus class/priority metadata.

    ``arrival_s`` is in *virtual seconds relative to the ``run()`` that
    serves the request*: 0.0 (the default) keeps the legacy behaviour —
    the request is queued the moment it is submitted.  ``priority``
    orders preemption victims (higher = more important; equal
    priorities degrade to the youngest-first rule).  ``klass`` is a
    free-form session-class label carried through to ``SessionResult``
    so per-class SLO metrics can be grouped (serving/trace.py)."""
    session_id: str
    prompt: Sequence[int]            # (S,) token ids
    max_new_tokens: int
    arrival_s: float = 0.0           # virtual arrival (0 = immediate)
    priority: int = 0                # preemption priority (higher wins)
    klass: str = ""                  # session-class label (SLO grouping)


@dataclasses.dataclass
class SessionResult:
    session_id: str
    tokens: np.ndarray               # (max_new_tokens,) generated ids
    slot: int                        # slot the session was served in
    admitted_tick: int
    finished_tick: int
    step_times_s: List[float]        # shared-batch decode-step walls
    klass: str = ""                  # session-class label (from request)
    priority: int = 0
    status: str = "ok"               # "ok" | "aborted" | "failed" |
                                     # "expired" — non-ok sessions ended
                                     # early (tokens is the committed
                                     # prefix, not the full budget)
    arrival_s: float = 0.0           # virtual arrival on the run clock
    token_times_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # virtual emission timestamp per generated token (same clock as
    # ``arrival_s``) — queueing, prefill, preemption stalls and macro-
    # tick position all included, so diffs are the per-token latency
    # the session FELT, not the shared-batch service wall
    ttft_s: Optional[float] = None   # token_times_s[0] - arrival_s
    ttft_wall_s: Optional[float] = None
    # wall-clock TTFT (queue release -> first token); None when the
    # scheduler ran timed=False — never NaN, so JSON stays clean

    def token_latencies_s(self) -> np.ndarray:
        """Virtual inter-token latencies (the TPOT stream): gaps
        between consecutive emission stamps.  Empty for 1-token
        sessions."""
        return np.diff(self.token_times_s)


@dataclasses.dataclass
class ContinuousResult:
    """Outcome of one ``SlotScheduler.run()`` call.

    ``run()`` may be called repeatedly on one scheduler (submit → run →
    submit → run); every field belongs to exactly one of two groups,
    and which group is part of its contract:

    **Cumulative** over the scheduler's lifetime (all ``run()`` calls so
    far): ``sessions``, ``events``, ``decode_steps``.
    ``step_cache_size``, ``launches_per_step``, ``steps_per_tick``,
    ``kv_tier``, and ``tier_policy`` describe the compiled program /
    configuration, not a count.

    **This ``run()`` call only** (delta since the call started):
    ``ticks``, ``wall_s``, ``tokens_per_s``, ``preemptions``,
    ``dispatches``, ``run_tokens``, ``step_kv_blocks``,
    ``host_dispatch_s``, ``host_sync_s``, ``prefill_tokens``,
    ``prefix_hits``, ``prefix_tokens_saved``, ``cow_copies``,
    ``arrivals``, ``horizon_hist``, the tier counters
    ``pages_spilled`` / ``pages_restored`` / ``tier_restores`` /
    ``host_prefix_hits``, and every fault/recovery counter
    (``fault_counts`` through ``retry_backoff_s``).  (``dispatches`` is
    the per-run delta of the cumulative ``decode_steps``;
    ``host_pages_used`` is the host-pool occupancy at the END of the
    call.)

    ``now_s`` is the scheduler's virtual clock at the end of the call —
    monotone across calls (a clock, not a counter); per-run virtual
    makespan is the difference of consecutive ``now_s`` readings."""
    sessions: Dict[str, SessionResult]  # cumulative: every finished session
    ticks: int                       # scheduler iterations this run()
    decode_steps: int                # batched decode dispatches (cumulative)
    wall_s: float
    tokens_per_s: float              # aggregate generated tokens / wall
    step_cache_size: Optional[int]   # compiled decode-step count (full_jit)
    launches_per_step: int           # host dispatches per decode step
    events: List[Event]              # cumulative event log
    preemptions: int = 0             # paged: sessions requeued for pages
    step_kv_blocks: Optional[List[int]] = None
    # paged: per decode step, summed ceil(live_len/page_size) over the
    # active lanes — the pages the fused kernel actually walks.  None
    # for contiguous runs.
    steps_per_tick: int = 1          # horizon K of the fused macro-tick
    dispatches: int = 0              # decode dispatches this run() call
    run_tokens: int = 0              # tokens generated this run() call
    host_dispatch_s: float = 0.0     # host wall building + dispatching
                                     # decode work (the launch term the
                                     # horizon amortises)
    host_sync_s: float = 0.0         # host wall blocked on the per-tick
                                     # token transfer
    prefill_tokens: int = 0          # tokens actually dispatched through
                                     # prefill programs this run()
    prefix_hits: int = 0             # admissions that matched a cached
                                     # prefix (prefix sharing; resumed
                                     # re-admissions count too, so this
                                     # may exceed the session count)
    prefix_tokens_saved: int = 0     # sequence tokens (prompt, plus the
                                     # generated prefix on resume) whose
                                     # prefill was skipped via shared
                                     # pages
    cow_copies: int = 0              # copy-on-write page faults served
    now_s: float = 0.0               # virtual clock at the end of the
                                     # call (monotone across calls)
    arrivals: int = 0                # trace requests released from the
                                     # arrival queue this run()
    adaptive_k: bool = False         # horizon chosen per tick (config)
    horizon_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # macro-ticks dispatched per horizon K this run() — the adaptive
    # policy's visible footprint ({} for single-step runs)
    kv_tier: str = "none"            # page-tier config ("none" | "host")
    tier_policy: Optional[str] = None   # placement policy name (tiered)
    pages_spilled: int = 0           # KV pages copied device->host
    pages_restored: int = 0          # KV pages copied host->device
    tier_restores: int = 0           # parked sessions resumed via restore
    host_prefix_hits: int = 0        # pages served from the host prefix
                                     # index on admission
    host_pages_used: int = 0         # host-pool occupancy at call end
    # ---- fault injection / graceful degradation (serving/faults.py) ----
    fault_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # injected faults that LANDED this run, by kind ({} without an
    # injector); ``faults_injected`` is their sum
    faults_injected: int = 0
    save_retries: int = 0            # host-tier save attempts repeated
    restore_retries: int = 0         # host-tier restore attempts repeated
    degraded_restores: int = 0       # restores abandoned for re-prefill
                                     # (retry budget spent / checksum)
    corrupt_blobs: int = 0           # parked blobs failing verify-on-
                                     # restore
    quarantines: int = 0             # lanes pulled by the logit screen
    aborted_sessions: int = 0        # mid-stream disconnects applied
    failed_sessions: int = 0         # fail-closed terminations
    expired_sessions: int = 0        # per-session TTL enforcements
    audit_failures: int = 0          # idle-tick self-audits that found
                                     # accounting damage
    retry_backoff_s: float = 0.0     # virtual seconds charged to retry
                                     # backoff (inside ``now_s``)

    def tokens_for(self, session_id: str) -> np.ndarray:
        return self.sessions[session_id].tokens


@dataclasses.dataclass
class _Session:
    """Scheduler-internal live-session state (one per submitted
    request); the public view is ``SessionResult``."""
    request: SessionRequest
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    admitted_tick: int = -1
    finished_tick: int = -1
    step_times_s: List[float] = dataclasses.field(default_factory=list)
    # ---- paged bookkeeping ----
    pages: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                     # host mirror of cache["pos"][slot]
    prefilled: int = 0               # prefill_seq tokens written so far
    prefill_seq: Optional[np.ndarray] = None   # sequence being prefilled
    seq_cache: Optional[np.ndarray] = None     # memoised admission seq
                                     # (valid while waiting: tokens only
                                     # grow while resident in a slot)
    resume: bool = False             # re-admission after preemption
    admit_seq: int = -1              # monotone admission order (preempt prio)
    status: str = "ok"               # terminal status (see SessionResult)
    quarantines: int = 0             # logit-screen pulls so far
    tier_waits: int = 0              # restore-gate patience ticks spent
    arrival_s: float = 0.0           # virtual arrival on the run clock
    release_wall: Optional[float] = None   # perf_counter at queue entry
    token_times_s: List[float] = dataclasses.field(default_factory=list)
    first_token_wall: Optional[float] = None

    @property
    def sid(self) -> str:
        return self.request.session_id

    @property
    def priority(self) -> int:
        return self.request.priority

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.request.max_new_tokens

    @property
    def decoding(self) -> bool:
        """Prefill complete: the session takes part in decode steps."""
        return (self.prefill_seq is not None
                and self.prefilled >= len(self.prefill_seq))

    @property
    def next_input_token(self) -> int:
        """Token the next decode step feeds this lane.  Normally the
        last generated token; a fully-prefix-matched fresh admission has
        generated nothing yet and replays the last prompt token (its KV
        row is rewritten in place — into the CoW private copy — and the
        step's logits stand in for the skipped prefill's)."""
        return (self.tokens[-1] if self.tokens
                else int(self.prefill_seq[-1]))

    def to_result(self) -> SessionResult:
        return SessionResult(
            session_id=self.request.session_id,
            tokens=np.asarray(self.tokens, np.int32),
            slot=self.slot,
            admitted_tick=self.admitted_tick,
            finished_tick=self.finished_tick,
            step_times_s=self.step_times_s,
            klass=self.request.klass,
            priority=self.request.priority,
            status=self.status,
            arrival_s=self.arrival_s,
            token_times_s=np.asarray(self.token_times_s),
            ttft_s=(self.token_times_s[0] - self.arrival_s
                    if self.token_times_s else None),
            ttft_wall_s=(self.first_token_wall - self.release_wall
                         if self.first_token_wall is not None
                         and self.release_wall is not None else None))
