"""Continuous-batching session scheduler over a slotted KV cache.

Port of ``repro.serving.scheduler``: the same admission order, page
gating, preemption, backfill, chunked prefill, prefix sharing with
copy-on-write pages, and K=1 and horizon-K ticks, with the same event
log and ``ContinuousResult``.  The decode batch dimension is the
constant slot count, so session churn never changes a program's shapes:
on the card the step is one captured CUDA graph per (route, K)
(serving/programs.py) and every host-side change — admission, eviction,
page grants, positions — lands in place in the tensors that graph reads
(``PageStore.sync``).  For the dispatch A/B, ``dispatch_mode`` "eager"
or "stage_jit" runs the K=1 step through the model's ``StepProgram``
executor instead (contiguous slots only, as in the reference).
Prefill, the page copy, the tier's restores and the cache are written in
place, and each program returns the same cache dict.

The host-DRAM KV tier (``kv_tier="host"``: preempted sessions park their
full pages host-side and re-admission restores them, placement steered
by a ``TierPolicy``), trace replay on the virtual clock
(``SessionRequest.arrival_s``, ``priority_preemption``) and fault
injection with recovery (``fault_injector``: bounded copy retries that
degrade to re-prefill, checksum rejects, the logit screen's quarantine,
aborts, the session TTL, pool-pressure holds, the idle-tick self-audit)
follow the reference event for event; the tier's copies run between
graph replays on the same stream.

Sampling draws from a ``torch.Generator`` seeded with ``seed``, eagerly
at K=1 and inside the captured graph at K > 1 (registered with it, so
captured and uncaptured ticks draw alike); greedy streams are the
contract, stochastic draws do not follow the reference's keys.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import MODES, launch_count
from repro_torch.models.model import Model
from repro_torch.serving.faults import FaultInjector, InjectedFault
from repro_torch.serving.memory import (BlockAllocator, PageStore, PrefixCache,
                                        TierCopyError, TieredPageStore,
                                        get_policy, restore_kv_blobs,
                                        save_kv_blobs)
from repro_torch.serving.programs import SchedulerPrograms
from repro_torch.serving.sampling import sample
from repro_torch.serving.session import (ContinuousResult, Event,
                                         SessionRequest, _Session)
from repro_torch.serving.vclock import VirtualClockMixin, build_k_ladder


class SlotScheduler(VirtualClockMixin):
    """Admission / decode / eviction / backfill over a slotted cache."""

    def __init__(self, model: Model, params, *, n_slots: int, max_len: int,
                 dispatch_mode: str = "full_jit", temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, kv_dtype=None,
                 max_ticks: Optional[int] = None, paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 steps_per_tick: int = 1, eos_id: Optional[int] = None,
                 timed: bool = True, prefix_cache: bool = False,
                 adaptive_k: bool = False, min_steps_per_tick: int = 1,
                 priority_preemption: bool = True,
                 virtual_step_s: float = 1e-3,
                 virtual_dispatch_s: float = 4e-3,
                 shared_programs: bool = False,
                 kv_tier: str = "none",
                 tier_policy="spill",
                 host_pages: Optional[int] = None,
                 virtual_host_copy_s: float = 5e-4,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_budget: int = 2,
                 session_ttl_s: Optional[float] = None,
                 restore_patience: int = 0,
                 quarantine_budget: int = 2,
                 self_audit: bool = False,
                 logit_screen: Optional[bool] = None):
        if n_slots < 1 or steps_per_tick < 1:
            raise ValueError(f"bad n_slots={n_slots} / steps_per_tick="
                             f"{steps_per_tick}")
        if not 1 <= min_steps_per_tick <= steps_per_tick:
            raise ValueError(f"min_steps_per_tick={min_steps_per_tick} must "
                             f"lie in [1, steps_per_tick={steps_per_tick}]")
        if kv_tier not in ("none", "host"):
            raise ValueError(f"kv_tier must be 'none' or 'host', got "
                             f"{kv_tier!r}")
        if retry_budget < 0 or restore_patience < 0 or quarantine_budget < 0:
            raise ValueError("retry_budget, restore_patience and "
                             "quarantine_budget must be >= 0")
        if session_ttl_s is not None and session_ttl_s <= 0:
            raise ValueError(f"session_ttl_s={session_ttl_s} must be > 0")
        if dispatch_mode not in MODES:
            raise ValueError(f"dispatch_mode must be one of {MODES}, got "
                             f"{dispatch_mode!r}")
        if adaptive_k and steps_per_tick < 2:
            raise NotImplementedError(
                "adaptive_k needs a horizon ceiling >= 2 to adapt below")
        if model.cfg.n_codebooks:
            raise NotImplementedError(
                "continuous batching serves single-codebook archs")
        if steps_per_tick > 1 and dispatch_mode != "full_jit":
            raise NotImplementedError(
                "horizon-K fused ticks ARE the one-program (full_jit) arm")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.dispatch_mode = dispatch_mode
        self.temperature = temperature
        self.top_k = top_k
        self.gen = torch.Generator(device=model.device).manual_seed(seed)
        self.max_ticks = max_ticks
        self.steps_per_tick = steps_per_tick
        self.eos_id = eos_id
        self.timed = timed
        self.host_dispatch_s = 0.0
        self.host_sync_s = 0.0
        self.adaptive_k = adaptive_k
        self.min_steps_per_tick = min_steps_per_tick
        self.priority_preemption = priority_preemption
        self.k_ladder: Tuple[int, ...] = build_k_ladder(
            steps_per_tick, min_steps_per_tick)
        # virtual clock (trace replay / SLO metrics): launch tax per
        # dispatch + service quantum per decode step + host-copy
        # quantum per migrated page; deterministic host arithmetic
        self.virtual_step_s = virtual_step_s
        self.virtual_dispatch_s = virtual_dispatch_s
        self.virtual_host_copy_s = virtual_host_copy_s
        # shared_programs is the reference's API only: each scheduler
        # captures its own graphs, which read its own cache's addresses
        self.now_s = 0.0
        self._pending: List[Tuple[float, int, _Session]] = []
        self._arrivals: List[Tuple[float, int, _Session]] = []
        self._arrival_seq = 0
        self.arrivals_released = 0
        self.horizon_hist: collections.Counter = collections.Counter()

        self._progs = SchedulerPrograms(model, paged=paged, kv_tier=kv_tier)
        self.paged = paged
        if prefix_cache and not paged:
            raise NotImplementedError(
                "prefix sharing rides the paged block table")
        if kv_tier != "none" and not paged:
            raise NotImplementedError(
                "the host KV tier spills pool pages; contiguous slots "
                "have none to migrate")
        if paged:
            if dispatch_mode != "full_jit":
                raise NotImplementedError(
                    "paged serving runs the full_jit arm only")
            if prefill_chunk is not None and (
                    prefill_chunk < page_size or prefill_chunk % page_size):
                raise ValueError("prefill_chunk must be a multiple of "
                                 "page_size")
            self.page_size = page_size
            self.max_blocks = -(-max_len // page_size)
            if n_pages is None:
                n_pages = 1 + n_slots * self.max_blocks   # full backing
            self.n_pages = n_pages
            self.prefill_chunk = prefill_chunk
            self.cache = model.init_cache(
                n_slots, max_len, kv_dtype=kv_dtype, paged=True,
                page_size=page_size, n_pages=n_pages)
        else:
            self.cache = model.init_cache(n_slots, max_len,
                                          kv_dtype=kv_dtype, slotted=True)
        # ---- fault tolerance (serving/faults.py; all default-off) ----
        self.fault_injector = fault_injector
        self.retry_budget = retry_budget
        self.session_ttl_s = session_ttl_s
        self.restore_patience = restore_patience
        self.quarantine_budget = quarantine_budget
        self.self_audit = self_audit
        self.logit_screen = logit_screen
        self._vocab = model.cfg.vocab_size
        self._pressure_holds: List[Tuple[float, List[int]]] = []
        self._pending_corrupts = 0
        self._pending_aborts: List[str] = []
        self._poison: List[str] = []
        self.quarantines = 0
        self.degraded_restores = 0
        self.aborted_sessions = 0
        self.failed_sessions = 0
        self.expired_sessions = 0
        self.audit_failures = 0
        self.retry_backoff_s = 0.0
        if paged:
            store_kw = dict(n_slots=n_slots, max_blocks=self.max_blocks,
                            page_size=page_size, n_pages=n_pages,
                            prefix_cache=prefix_cache)
            if kv_tier == "host":
                def _save_fn(cache, pages):
                    self._injected("save")
                    return save_kv_blobs(self._progs.save_pages, cache,
                                         pages, self.store.host)

                def _restore_fn(cache, pages, blobs):
                    self._injected("restore")
                    return restore_kv_blobs(self._progs.restore_pages,
                                            cache, pages, blobs)

                self.store: Optional[PageStore] = TieredPageStore(
                    host_pages=(host_pages if host_pages is not None
                                else n_pages - 1),
                    policy=get_policy(tier_policy),
                    save_fn=_save_fn, restore_fn=_restore_fn,
                    get_cache=lambda: self.cache,
                    charge_cb=self._charge_migration,
                    retry_budget=retry_budget,
                    retry_cb=self._charge_retry,
                    pin_memory=model.device.type == "cuda", **store_kw)
                # the host rows, page-locked on the card, allocated now
                self.store.host.allocate(tuple(
                    self.cache[k][:, 0]
                    for k in model._page_slab_keys(self.cache)))
            else:
                self.store = PageStore(**store_kw)
        else:
            self.store = None
        self.tiered = paged and self.store.kv_tier == "host"

        self.preemptions = 0
        self.step_kv_blocks: List[int] = []
        self.slots: List[Optional[_Session]] = [None] * n_slots
        self.waiting: Deque[_Session] = collections.deque()
        self.finished: List[_Session] = []
        self.events: List[Event] = []
        self.tick_count = 0
        self.decode_steps = 0
        self.prefill_tokens = 0     # tokens dispatched through prefill
        self.prefix_hits = 0        # admissions matching a cached prefix
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        self._admission_order = 0   # monotone admission id (preempt prio)
        if dispatch_mode == "full_jit":
            self._program = self._executor = None
        else:
            # dispatch A/B: the StepProgram decomposition's executors
            self._program = model.step_program(params, self.cache)
            self._executor = self._program.executor(dispatch_mode)

    # ------------------------------------------------------------- intro
    @property
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def active_sessions(self) -> List[str]:
        return [s.request.session_id for s in self.slots if s is not None]

    @property
    def allocator(self) -> Optional[BlockAllocator]:
        return self.store.allocator if self.paged else None

    @property
    def prefix(self) -> Optional[PrefixCache]:
        return self.store.prefix if self.paged else None

    @property
    def free_pages(self) -> Optional[int]:
        return self.store.free_pages if self.paged else None

    @property
    def cached_pages(self) -> Optional[int]:
        """Pages held by the prefix cache (None when sharing is off)."""
        return self.store.cached_pages if self.paged else None

    def flush_prefix_cache(self) -> int:
        """Drop every unreferenced cached prefix page to the free list."""
        return self.store.flush_prefix() if self.paged else 0

    def step_cache_size(self) -> Optional[int]:
        """Decode-step CUDA graphs captured (one per (route, K); None on
        the CPU, where nothing is captured)."""
        return self._progs.raw_step_cache_size()

    @property
    def launches_per_step(self) -> int:
        if self._program is not None:
            return launch_count(self._program, self.dispatch_mode)
        return 1  # full_jit: one graph replay per decode dispatch

    # ------------------------------------------------------------- queue
    def submit(self, request: SessionRequest) -> None:
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size < 1 or request.max_new_tokens < 1:
            raise ValueError(f"session {request.session_id}: empty prompt or "
                             "token budget")
        # last decode write lands at S + max_new - 2; keep it in-cache
        if prompt.size + request.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"session {request.session_id}: prompt {prompt.size} + "
                f"{request.max_new_tokens} new exceeds max_len {self.max_len}")
        if self.paged:
            need = self._pages_for(prompt.size + request.max_new_tokens - 1)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"session {request.session_id} needs {need} pages; the "
                    f"pool holds {self.n_pages - 1}")
        req = dataclasses.replace(request, prompt=prompt)
        sess = _Session(req)
        if req.arrival_s > 0.0:
            # trace replay: queued once the virtual clock reaches the
            # arrival; times are rebased to the serving run()
            self._pending.append((float(req.arrival_s),
                                  self._arrival_seq, sess))
            self._arrival_seq += 1
        else:
            sess.arrival_s = self.now_s
            sess.release_wall = time.perf_counter() if self.timed else None
            self.waiting.append(sess)

    # ----------------------------------------------------------- serving
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.gen, temperature=self.temperature,
                      top_k=self.top_k)

    def _hit_eos(self, tok: int) -> bool:
        return self.eos_id is not None and tok == self.eos_id

    def _finish(self, slot: int, sess: _Session) -> None:
        sess.finished_tick = self.tick_count
        self.slots[slot] = None
        self.finished.append(sess)
        if self.paged:
            self.store.drop_shadows(sess.sid)   # stale pre-spills die
            self._release_slot(slot, sess)
        self.events.append(("finish", sess.sid, slot))

    # ------------------------------------------------- fault tolerance
    @property
    def _screen_logits(self) -> bool:
        """The NaN/Inf (K=1) / token-range (horizon) screen on sampled
        output: explicit ``logit_screen`` wins, else on exactly when an
        injector is attached (resolved per call, so a soak can swap
        injectors on a cached scheduler)."""
        return (self.logit_screen if self.logit_screen is not None
                else self.fault_injector is not None)

    def _injected(self, which: str) -> None:
        """Raise ``InjectedFault`` when the plan armed a copy failure
        for this save/restore call (consulted per call — see above)."""
        inj = self.fault_injector
        if inj is not None and inj.take_copy_fail(which):
            raise InjectedFault(f"injected {which} copy failure")

    def _charge_retry(self, attempt: int) -> None:
        """Virtual cost of one copy retry: exponential backoff in
        launch-tax units, doubling per attempt — charged to the same
        clock everything else pays, so chaos SLO numbers include it."""
        dt = self.virtual_dispatch_s * (2 ** (attempt - 1))
        self.now_s += dt
        self.retry_backoff_s += dt

    def _take_poison(self, sid: str) -> bool:
        """Consume a pending logit poisoning aimed at ``sid`` (or at
        anyone, target "")."""
        for i, t in enumerate(self._poison):
            if t == sid or t == "":
                del self._poison[i]
                if self.fault_injector is not None:
                    self.fault_injector.mark("nan_logits")
                return True
        return False

    def _bump_status(self, status: str) -> None:
        self.aborted_sessions += status == "aborted"
        self.failed_sessions += status == "failed"
        self.expired_sessions += status == "expired"

    def _abort_session(self, sid: str, status: str) -> bool:
        """Terminally remove a session wherever it lives — resident,
        waiting, or still queued in the arrival stream — freeing its
        slot, pages, and host blobs.  Committed tokens are kept (the
        result carries the prefix plus a non-ok ``status``).  False
        when the session is unknown or already finished (a disconnect
        racing completion is not an error)."""
        for slot, sess in enumerate(self.slots):
            if sess is not None and sess.sid == sid:
                sess.status = status
                self._bump_status(status)
                self.events.append((status, sid, slot))
                self._finish(slot, sess)
                return True
        for sess in self.waiting:
            if sess.sid == sid:
                self.waiting.remove(sess)
                sess.status = status
                sess.finished_tick = self.tick_count
                self.finished.append(sess)
                if self.paged:
                    self.store.drop_shadows(sid)
                    self.store.drop_parked(sid)
                self._bump_status(status)
                self.events.append((status, sid, -1))
                return True
        for queue in (self._arrivals, self._pending):
            for entry in queue:
                if entry[2].sid == sid:
                    queue.remove(entry)
                    if queue is self._arrivals:
                        heapq.heapify(self._arrivals)
                    sess = entry[2]
                    sess.status = status
                    sess.finished_tick = self.tick_count
                    self.finished.append(sess)
                    self._bump_status(status)
                    self.events.append((status, sid, -1))
                    return True
        return False

    def _poll_faults(self) -> None:
        """Apply due fault-plan events and enforce the per-session TTL.
        Runs right after arrival release each tick; a no-op without an
        injector, TTL, or live pressure hold."""
        inj = self.fault_injector
        if inj is None and self.session_ttl_s is None \
                and not self._pressure_holds:
            return
        # expire pressure holds: withheld pages return to the free list
        # the moment the virtual clock passes the spike
        if self._pressure_holds:
            live = []
            for expiry, pages in self._pressure_holds:
                if self.now_s >= expiry:
                    self.store.release(pages)
                else:
                    live.append((expiry, pages))
            self._pressure_holds = live
        if inj is not None:
            for spec in inj.poll(self.now_s):
                if spec.kind == "pool_pressure":
                    if not self.paged:
                        continue         # no pool to pressure
                    got = self.store.alloc_free(
                        min(spec.count, self.store.free_pages))
                    if got:
                        self._pressure_holds.append(
                            (self.now_s + spec.duration_s, got))
                        inj.mark("pool_pressure")
                        self.events.append(("pressure", "", -1,
                                            len(got)))
                elif spec.kind == "blob_corrupt":
                    self._pending_corrupts += spec.count
                elif spec.kind == "nan_logits":
                    self._poison.append(spec.target)
                elif spec.kind == "abort":
                    self._pending_aborts.append(spec.target)
            # corruption bites whatever is parked NOW; pending damage
            # waits for the next parked blob instead of going unfired
            while self._pending_corrupts and self.tiered:
                sid = self.store.corrupt_parked_blob()
                if sid is None:
                    break
                self._pending_corrupts -= 1
                inj.mark("blob_corrupt")
                self.events.append(("corrupt", sid, -1))
            if not self.tiered:
                self._pending_corrupts = 0
            if self._pending_aborts:
                rest = []
                for target in self._pending_aborts:
                    if target:
                        # a disconnect racing completion just drops
                        if self._abort_session(target, "aborted"):
                            inj.mark("abort")
                        continue
                    sid = next(
                        (s.sid for s in self.slots if s is not None),
                        None) or (self.waiting[0].sid if self.waiting
                                  else None)
                    if sid is None:
                        rest.append(target)   # nobody live yet: retry
                    else:
                        self._abort_session(sid, "aborted")
                        inj.mark("abort")
                self._pending_aborts = rest
        if self.session_ttl_s is not None:
            overdue = [s for s in list(self.slots) + list(self.waiting)
                       if s is not None
                       and self.now_s - s.arrival_s > self.session_ttl_s]
            for s in overdue:
                self._abort_session(s.sid, "expired")

    def _run_audit(self) -> None:
        """Idle-tick self-audit of the page accounting; first damage
        warns (an "audit" event), repeated damage fails the run closed
        — continuing to serve on a corrupt allocator turns one broken
        session into silently wrong streams for everyone."""
        live = [p for s in self.slots if s is not None for p in s.pages]
        issues = self.store.check(live)
        if not issues:
            return
        self.audit_failures += 1
        self.events.append(("audit", "; ".join(issues)[:200], -1))
        if self.audit_failures > 1:
            raise RuntimeError(
                "page-accounting self-audit failed twice: "
                + "; ".join(issues))

    def _quarantine(self, slot: int, sess: _Session) -> None:
        """Pull a lane whose sampled output failed the logit screen.
        Paged sessions requeue and re-prefill from their committed
        prefix (the poisoned step never committed, so recovery is
        token-identical); past the quarantine budget — or on the
        contiguous layout, which has no resume machinery — the session
        fails closed with a terminal event."""
        self.quarantines += 1
        sess.quarantines += 1
        self.events.append(("quarantine", sess.sid, slot))
        if not self.paged or sess.quarantines > self.quarantine_budget:
            sess.status = "failed"
            self._bump_status("failed")
            self.events.append(("failed", sess.sid, slot))
            self._finish(slot, sess)
            return
        self._requeue(slot, sess)

    # ------------------------------------------------------ paged plumbing
    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _release_slot(self, slot: int, sess: _Session) -> None:
        """Reclaim a session's pages and park the lane on the sentinel."""
        self.store.release(sess.pages)
        sess.pages = []
        self.store.clear_slot(slot)

    def _sync_device(self, pos_always: bool = True) -> None:
        self.store.sync(self.cache, pos_always)

    def _requeue(self, slot: int, sess: _Session) -> None:
        """Pull a resident session back to the head of the queue,
        parking its full pages (tiered) or dropping them — the shared
        prologue of preemption and quarantine.  Costs recompute (or
        copies), never correctness."""
        if self.tiered and self.store.policy.spill_parked \
                and sess.pos >= self.page_size:
            self.store.park(sess.sid, sess.pos // self.page_size,
                            sess.pages, self.cache)
        elif self.paged:
            self.store.drop_shadows(sess.sid)
        self._release_slot(slot, sess)
        self.slots[slot] = None
        sess.slot = -1
        sess.prefilled = 0
        sess.prefill_seq = None
        sess.resume = True
        sess.tier_waits = 0
        self.waiting.appendleft(sess)   # it was admitted before the waiters

    def _preempt(self, slot: int, sess: _Session) -> None:
        """Requeue a session to reclaim its pages; the host tier parks
        full pages; the partial tail always re-prefills."""
        self._requeue(slot, sess)
        self.preemptions += 1
        self.events.append(("preempt", sess.sid, slot))

    def _alloc_or_preempt(self, n: int, needy: _Session) -> Optional[List[int]]:
        """Allocate ``n`` pages, preempting one victim at a time until
        it fits (None if it still can't).  Victims: lowest-priority-
        youngest first (youngest-first when priority preemption is off)."""
        while True:
            got = self.store.alloc(n)
            if got is not None:
                return got
            if self.priority_preemption:
                victims = [((-s.priority, s.admit_seq), i, s)
                           for i, s in enumerate(self.slots)
                           if s is not None and s is not needy
                           and (s.priority < needy.priority
                                or (s.priority == needy.priority
                                    and s.admit_seq > needy.admit_seq))]
            else:
                victims = [((0, s.admit_seq), i, s)
                           for i, s in enumerate(self.slots)
                           if s is not None and s is not needy
                           and s.admit_seq > needy.admit_seq]
            if not victims:
                return None
            _, vslot, vsess = max(victims)
            self._preempt(vslot, vsess)

    def _next_chunk_len(self, sess: _Session) -> int:
        remaining = len(sess.prefill_seq) - sess.prefilled
        if self.prefill_chunk is None:
            return remaining
        return min(self.prefill_chunk, remaining)

    def _emit_first(self, slot: int, sess: _Session,
                    logits: torch.Tensor) -> None:
        """Sample a session's first token from its prefill logits."""
        tok = int(self._sample(logits[:, -1])[0])
        sess.tokens.append(tok)
        self._stamp(sess)
        self.events.append(("token", sess.sid, slot, tok))
        if sess.done or self._hit_eos(tok):
            self._finish(slot, sess)

    def _prefill_next_chunk(self, slot: int, sess: _Session) -> bool:
        """Run ONE prefill chunk (allocating its pages first); False
        when pages stay short after preemption — retried next tick."""
        start = sess.prefilled
        C = self._next_chunk_len(sess)
        need = self._pages_for(start + C) - len(sess.pages)
        if need > 0:
            got = self._alloc_or_preempt(need, sess)
            if got is None:
                return False
            base = len(sess.pages)
            sess.pages.extend(got)
            self.store.map_pages(slot, base, got)
        self._sync_device()
        chunk = torch.from_numpy(sess.prefill_seq[start:start + C])
        logits, self.cache = self._progs.prefill_chunk(
            self.params, {"tokens": chunk[None, :].to(self.model.device)},
            self.cache, slot, start)
        sess.prefilled = start + C
        sess.pos = sess.prefilled
        self.store.set_pos(slot, sess.prefilled)
        self.prefill_tokens += C
        self._charge(1)          # one prefill program: launch + a quantum
        self._register_prefix(sess)
        if sess.decoding:
            # prefill complete: sample the first token — unless resuming,
            # where the last generated token re-feeds through decode
            resumed = sess.resume and sess.tokens
            sess.resume = False
            if not resumed:
                self._emit_first(slot, sess, logits)
        return True

    def _register_prefix(self, sess: _Session) -> None:
        """Index the session's fully-prefilled pages for sharing."""
        self.store.register(sess.prefill_seq, sess.pages,
                            sess.prefilled // self.page_size)

    @staticmethod
    def _prefill_seq_for(sess: _Session) -> np.ndarray:
        """The sequence admission must make resident: prompt, plus on
        resume all but the last generated token (that one re-feeds
        through decode).  Memoised while the head waits at the gate."""
        if sess.seq_cache is None:
            sess.seq_cache = (
                np.concatenate([sess.request.prompt,
                                np.asarray(sess.tokens[:-1], np.int32)])
                if sess.resume and sess.tokens else
                np.asarray(sess.request.prompt, np.int32))
        return sess.seq_cache

    def _admit_paged(self, slot: int, sess: _Session, seq: np.ndarray,
                     shared: List[int]) -> None:
        """Install a session in ``slot``, aliasing the ``shared`` prefix
        pages so only the tail past the match prefills.  A whole-
        sequence match leaves nothing to prefill: resumes decode at
        once; a fresh prompt replays its last token through decode,
        CoW-faulting the last shared page first (shared pages are never
        written)."""
        sess.prefill_seq = seq
        sess.seq_cache = None        # tokens grow while resident
        sess.prefilled = 0
        sess.pages = []
        sess.slot = slot
        sess.admitted_tick = self.tick_count
        sess.admit_seq = self._admission_order
        self._admission_order += 1
        self.slots[slot] = sess
        self.store.clear_slot(slot)
        self.events.append(("admit", sess.sid, slot))
        if not shared:
            return
        k = len(shared)
        matched = k * self.page_size
        self.prefix_hits += 1
        if matched < len(seq):
            # tail remains: share the matched run, prefill only the tail
            # (fresh private pages — no CoW needed)
            self.store.retain(shared)
            sess.pages = list(shared)
            self.store.map_pages(slot, 0, shared)
            sess.prefilled = matched
            sess.pos = matched
            self.store.set_pos(slot, matched)
            self.prefix_tokens_saved += matched
        elif sess.resume and sess.tokens:
            # fully cached resume: nothing to prefill, nothing to sample
            self.store.retain(shared)
            sess.pages = list(shared)
            self.store.map_pages(slot, 0, shared)
            sess.prefilled = len(seq)
            sess.pos = len(seq)
            self.store.set_pos(slot, len(seq))
            sess.resume = False
            self.prefix_tokens_saved += len(seq)
        else:
            # fully cached fresh prompt: CoW-fault the last shared page.
            # Retain BEFORE allocating — the allocation may reclaim
            # cached pages (legally even the unretained source page
            # itself, degrading the copy to an in-place no-op).
            self.store.retain(shared[:-1])
            got = self.store.alloc(1)
            if got is None:
                self.store.release(shared[:-1])
                raise RuntimeError("admission gate did not cover the CoW page")
            sess.pages = list(shared[:-1]) + got
            self.store.map_pages(slot, 0, sess.pages)
            self.cache = self._progs.copy_page(self.cache, shared[-1], got[0])
            self.cow_copies += 1
            self._charge(0)      # the CoW copy is one dispatched program
            sess.prefilled = len(seq)
            sess.pos = len(seq) - 1
            self.store.set_pos(slot, len(seq) - 1)
            self.prefix_tokens_saved += len(seq)

    def _try_admit_tiered(self, slot: int) -> bool:
        """Tier-aware admission of the queue head: restore parked (or
        host-prefix-indexed) KV pages into fresh device pages instead
        of re-prefilling.  The device prefix cache is consulted first —
        blocks it covers alias and their parked blobs drop.  False when
        the host tier has nothing or the page gate can't cover the
        restore; the re-prefill admission then runs and stays the
        liveness anchor.  Restored bytes are the originally written
        bytes: the resumed stream is token-identical by construction."""
        store, head = self.store, self.waiting[0]
        seq = self._prefill_seq_for(head)
        shared = store.match(seq)
        k = len(shared)
        n_parked = store.parked_blocks(head.sid)
        if n_parked > k:
            paths = None
            n_restore = n_parked - k
            covered = n_parked * self.page_size
        else:
            # host prefix index: extend the device match, capped one
            # block short of the sequence so a fresh session keeps >= 1
            # tail token to prefill (first sample needs its logits)
            paths = store.host_match(seq, k,
                                     (len(seq) - 1) // self.page_size)
            if not paths:
                return False
            n_restore = len(paths)
            covered = (k + n_restore) * self.page_size
        if covered < len(seq):
            tail = len(seq) - covered
            first = (tail if self.prefill_chunk is None
                     else min(self.prefill_chunk, tail))
            need = self._pages_for(covered + first) - k
        else:
            need = n_restore + 1    # +1: first decode write headroom
        if not store.can_cover(need, shared):
            return False
        store.retain(shared)        # pin BEFORE the restore allocation
        got = store.alloc(n_restore)
        if got is None:
            store.release(shared)
            raise RuntimeError("the tier gate did not cover the restore pages")
        try:
            if paths is None:
                self.cache = store.take_parked(head.sid, k, got, self.cache)
            else:
                self.cache = store.restore_host_prefix(paths, got, self.cache)
        except TierCopyError:
            # degraded admission: the copy (or its checksum) failed past
            # the retry budget.  Give every reservation back — device
            # pages AND the prefix pin — drop the (possibly corrupt)
            # parked copy, and fall through to the re-prefill admission
            # THIS tick: token-identical by construction, no livelock.
            store.release(got)
            store.release(shared)
            store.drop_parked(head.sid)
            self.degraded_restores += 1
            self.events.append(("degraded", head.sid, slot))
            return False
        self.waiting.popleft()
        self._admit_paged(slot, head, seq, [])
        if shared:
            self.prefix_hits += 1
        head.pages = list(shared) + got
        self.store.map_pages(slot, 0, head.pages)
        head.prefilled = covered
        head.pos = covered
        store.set_pos(slot, covered)
        self.prefix_tokens_saved += covered
        self._register_prefix(head)   # restored blocks become shareable
        if covered == len(seq):
            head.resume = False       # fully covered: decode directly
        return True

    def _backfill_paged(self) -> None:
        """FIFO admission gated on free pages (head-of-line blocking is
        deliberate — skip-ahead would starve long prompts).  The host
        tier gets first refusal; the ordinary gate charges only the
        UNMATCHED pages, counting reclaimable cached pages as free —
        excluding the match itself, which is about to be pinned."""
        for slot in range(self.n_slots):
            while self.slots[slot] is None and self.waiting:
                if self.tiered and self._try_admit_tiered(slot):
                    sess = self.slots[slot]
                else:
                    head = self.waiting[0]
                    if self.tiered and self.restore_patience > 0 \
                            and head.tier_waits < self.restore_patience \
                            and self.store.parked_blocks(head.sid) > 0:
                        # restore-gate patience: the parked copy exists
                        # but the page gate can't cover it yet — hold a
                        # bounded number of ticks before the re-prefill
                        # admission supersedes (and discards) the copy
                        head.tier_waits += 1
                        return
                    seq = self._prefill_seq_for(head)
                    shared = self.store.match(seq)
                    while True:
                        matched = len(shared) * self.page_size
                        if shared and matched >= len(seq):
                            # fully cached: fresh needs 1 page (the CoW
                            # copy) pinning shared[:-1]; resume pins the
                            # whole match, +1 decode-write headroom
                            resume = head.resume and head.tokens
                            pinned = shared if resume else shared[:-1]
                            need = 1
                        else:
                            pinned = shared
                            tail = len(seq) - matched
                            first = (tail if self.prefill_chunk is None
                                     else min(self.prefill_chunk, tail))
                            need = (self._pages_for(matched + first)
                                    - len(shared))
                        if self.store.can_cover(need, pinned):
                            break
                        if not shared:
                            return      # gate: wait for reclaim
                        # shrink the match: its dropped tail pages
                        # become reclaimable fuel for this admission
                        # (degrades to the unshared gate = liveness)
                        shared = shared[:-1]
                    self._admit_paged(slot, self.waiting.popleft(), seq,
                                      shared)
                    # re-prefill admission supersedes any parked copy
                    self.store.drop_parked(head.sid)
                    sess = self.slots[slot]
                if not sess.decoding and not self._prefill_next_chunk(slot,
                                                                      sess):
                    raise RuntimeError("gated admission must have its first "
                                       "chunk")
                if self.slots[slot] is not None and \
                        not self.slots[slot].decoding:
                    break           # chunked prefill continues next ticks

    # -------------------------------------------------------- contiguous
    def _backfill(self) -> None:
        """FIFO admission into free slots; prefill-into-slot per session."""
        if self.paged:
            self._backfill_paged()
            return
        for slot in range(self.n_slots):
            while self.slots[slot] is None and self.waiting:
                sess = self.waiting.popleft()
                prompt = torch.from_numpy(sess.request.prompt)[None, :]
                logits, self.cache = self._progs.prefill_slot(
                    self.params, {"tokens": prompt.to(self.model.device)},
                    self.cache, slot)
                sess.slot = slot
                sess.admitted_tick = self.tick_count
                self.slots[slot] = sess
                self.prefill_tokens += int(prompt.shape[1])
                self._charge(1)
                self.events.append(("admit", sess.sid, slot))
                # a 1-token / instant-EOS session retires at once; the
                # loop backfills the slot
                self._emit_first(slot, sess, logits)

    def _ensure_decode_page(self, slot: int, sess: _Session) -> bool:
        """Guarantee the page under ``sess.pos`` exists, preempting
        younger sessions if the pool is dry; failing that, the needy
        session itself is preempted (an older one holds the pool)."""
        blk = sess.pos // self.page_size
        if blk < len(sess.pages):
            return True
        if blk != len(sess.pages):
            raise RuntimeError("page allocation skipped a block")
        got = self._alloc_or_preempt(1, sess)
        if got is None:
            self._preempt(slot, sess)
            return False
        self.store.map_pages(slot, blk, got)
        sess.pages.extend(got)
        return True

    def _reserve_horizon(self, slot: int, sess: _Session, want: int) -> int:
        """Pre-reserve pages for ``want`` decode steps of one fused
        macro-tick.  Lookahead past the next step is *optional*
        (free-list-only); only the MANDATORY next page preempts, like
        ``_ensure_decode_page``.  Returns steps granted; 0 = the
        session itself was preempted."""
        def take(n_pages: int) -> bool:
            got = self.store.alloc_free(n_pages)
            if got is None:
                return False
            base = len(sess.pages)
            sess.pages.extend(got)
            self.store.map_pages(slot, base, got)
            return True

        def top_up(n_steps: int) -> bool:
            need = self._pages_for(sess.pos + n_steps) - len(sess.pages)
            return need <= 0 or take(need)

        if top_up(want):
            return want
        # partial lookahead: take what the free list can spare, leaving
        # one page per OTHER live decoding slot so optional lookahead
        # never forces a later mandatory allocation into preempting
        others = sum(1 for i, s in enumerate(self.slots)
                     if s is not None and s is not sess and s.decoding)
        spare = self.store.free_pages - others
        need = self._pages_for(sess.pos + want) - len(sess.pages)
        if 0 < spare < need:
            take(spare)
        have = len(sess.pages) * self.page_size - sess.pos
        if have >= 1:
            return min(want, have)       # shrink: lookahead is optional
        # pool dry at a page boundary: the next page is mandatory —
        # preempt younger sessions (or the needy itself) like K=1 does
        got = self._alloc_or_preempt(1, sess)
        if got is None:
            self._preempt(slot, sess)
            return 0
        self.store.map_pages(slot, len(sess.pages), got)
        sess.pages.extend(got)
        if top_up(want):                 # eviction may have freed plenty
            return want
        return min(want, len(sess.pages) * self.page_size - sess.pos)

    def tick(self) -> List[Event]:
        """One iteration: continue chunked prefills, backfill, tier idle
        work, one batched decode dispatch, evict completed sessions."""
        n_before = len(self.events)
        steps0, pf0 = self.decode_steps, self.prefill_tokens
        self._release_arrivals()
        self._poll_faults()
        if self.paged:
            for slot, sess in enumerate(self.slots):
                if sess is not None and not sess.decoding:
                    self._prefill_next_chunk(slot, sess)
        self._backfill()
        if self.tiered and not self.waiting and not self._arrivals:
            # no admission pressure: let the policy pre-migrate
            # (LookAheadSpill shadow-copies the predicted victim)
            self.store.policy.idle_tick(self)
        if self.paged and self.self_audit and not self.waiting \
                and all(s is None for s in self.slots):
            self._run_audit()     # idle tick: audit the page accounting
        if self.steps_per_tick == 1:
            self._decode_tick_single()
        else:
            self._decode_tick_horizon(self._tick_horizon())
        if self._pressure_holds and self.decode_steps == steps0 \
                and self.prefill_tokens == pf0 \
                and len(self.events) == n_before:
            # a pressure spike can gate every admission with nothing
            # resident and no arrival to fast-forward to: jump the clock
            # to the next hold expiry so the spike passes
            self.now_s = max(self.now_s,
                             min(e for e, _ in self._pressure_holds))
        self.tick_count += 1
        return self.events[n_before:]

    def _decode_tick_single(self) -> None:  # staticcheck: hotpath
        """K=1 decode: one dispatch + one host round-trip per token."""
        if self.paged:
            for slot, sess in list(enumerate(self.slots)):
                if sess is not None and sess.decoding and \
                        self.slots[slot] is sess:
                    self._ensure_decode_page(slot, sess)
            self._sync_device()
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and (not self.paged or s.decoding)]
        if not active:
            return
        toks = np.zeros((self.n_slots, 1), np.int32)
        for slot, sess in active:
            toks[slot, 0] = sess.next_input_token
        if self.paged:
            # blocks this step reads per live lane (pos+1 counts the
            # written row) — the KV traffic of the fused kernel
            self.step_kv_blocks.append(sum(
                -(-(sess.pos + 1) // self.page_size)
                for _, sess in active))
        t0 = time.perf_counter()
        logits, self.cache = self._run_step(torch.from_numpy(toks))
        nxt = self._sample(logits[:, -1])
        t1 = time.perf_counter()
        # staticcheck: disable=hot-sync -- the ONE deliberate per-tick sync: sampled tokens must reach the host to be emitted
        nxt = np.asarray(nxt.cpu())
        t2 = time.perf_counter()
        self.host_dispatch_s += t1 - t0
        self.host_sync_s += t2 - t1
        dt = t2 - t0
        self.decode_steps += 1
        self._charge(1)
        screened: set = set()
        if self._screen_logits:
            # NaN/Inf screen on this step's logits — a writable HOST
            # copy: injected poison lands here, device state stays clean
            # staticcheck: disable=hot-sync -- NaN screen needs a writable host copy; only taken when --screen-logits is on (chaos runs)
            last = np.array(logits[:, -1].float().cpu(), np.float32)
            for slot, sess in active:
                if self._poison and self._take_poison(sess.sid):
                    last[slot] = np.nan
                if not np.isfinite(last[slot]).all():
                    screened.add(slot)
        for slot, sess in active:
            if slot in screened:
                # poisoned step never commits: quarantine the lane,
                # other lanes proceed untouched
                self._quarantine(slot, sess)
                continue
            sess.pos += 1
            if self.paged:
                self.store.mirror_pos(slot, sess.pos)
            tok = int(nxt[slot])
            sess.tokens.append(tok)
            self._stamp(sess)
            if self.timed:
                sess.step_times_s.append(dt)
            self.events.append(("token", sess.sid, slot, tok))
            if sess.done or self._hit_eos(tok):
                self._finish(slot, sess)

    def _run_step(self, tokens: torch.Tensor):  # staticcheck: hotpath
        if self._executor is None:
            return self._progs.step(self.params, self.cache, tokens)
        state = self._executor({"tokens": tokens.to(self.model.device),
                                "cache": self.cache})
        return state["logits"], state["cache"]

    def _decode_tick_horizon(self, K: int) -> None:  # staticcheck: hotpath
        """Horizon-K fused decode: ONE program advances every live slot
        up to ``K`` tokens (on-device sampling), the (n_slots, K) token
        matrix returns in one transfer, and the host reconciles
        afterwards — trimming lanes that hit EOS or budget mid-horizon
        (masked no-ops on device).  Pages covering each granted horizon
        are reserved BEFORE dispatch."""
        plan: Dict[int, int] = {}
        for slot, sess in list(enumerate(self.slots)):
            # skip free lanes, mid-prefill lanes, and lanes an earlier
            # reservation's preemption already evicted
            if sess is None or (self.paged and not sess.decoding) or \
                    self.slots[slot] is not sess:
                continue
            want = min(K, sess.request.max_new_tokens - len(sess.tokens))
            plan[slot] = (self._reserve_horizon(slot, sess, want)
                          if self.paged else want)
        if self.paged:
            self._sync_device(pos_always=False)
        active = [(i, s) for i, s in enumerate(self.slots)
                  if plan.get(i, 0) >= 1 and s is not None]
        if not active:
            return
        toks = np.zeros((self.n_slots, 1), np.int32)
        steps_left = np.zeros((self.n_slots,), np.int32)
        for slot, sess in active:
            toks[slot, 0] = sess.next_input_token
            steps_left[slot] = plan[slot]
        t0 = time.perf_counter()
        tok_mat, self.cache = self._progs.steps(
            self.params, self.cache, torch.from_numpy(toks),
            torch.from_numpy(steps_left), self.gen, horizon=K,
            temperature=self.temperature, top_k=self.top_k,
            eos_id=self.eos_id)
        t1 = time.perf_counter()
        # staticcheck: disable=hot-sync -- the ONE deliberate macro-tick sync: up to K*slots sampled tokens in one transfer
        tok_mat = np.array(tok_mat.cpu())   # a writable host copy
        t2 = time.perf_counter()
        screen = self._screen_logits
        if screen:
            for slot, sess in active:
                if self._poison and self._take_poison(sess.sid):
                    # out-of-vocab sentinel on the lane's whole horizon:
                    # the range check below quarantines at step 0, so no
                    # poisoned token ever commits
                    tok_mat[slot, :] = self._vocab
        self.host_dispatch_s += t1 - t0
        self.host_sync_s += t2 - t1
        dt = t2 - t0
        self.decode_steps += 1
        self.horizon_hist[K] += 1
        # ---- reconciliation: step-major walk mirrors the device loop ----
        per_tok_dt = dt / K
        max_steps = max(plan[slot] for slot, _ in active)
        vt0 = self.now_s + self.virtual_dispatch_s
        self._charge(max_steps)
        kv_blocks = [0] * max_steps
        emitted = [0] * max_steps
        done: set = set()
        for j in range(max_steps):
            for slot, sess in active:
                if slot in done or j >= plan[slot]:
                    continue
                tok = int(tok_mat[slot, j])
                if screen and not 0 <= tok < self._vocab:
                    # screened lane: nothing from this horizon commits
                    done.add(slot)
                    self._quarantine(slot, sess)
                    continue
                sess.pos += 1
                if self.paged:
                    self.store.mirror_pos(slot, sess.pos)
                    # blocks this device step walked for the lane: its
                    # live length after the write (same accounting as K=1)
                    kv_blocks[j] += -(-sess.pos // self.page_size)
                emitted[j] += 1
                sess.tokens.append(tok)
                # step j's token leaves at the j+1'th quantum — stamps
                # see positions inside the fused horizon, not tick ends
                self._stamp(sess, vt0 + (j + 1) * self.virtual_step_s)
                if self.timed:
                    sess.step_times_s.append(per_tok_dt)
                self.events.append(("token", sess.sid, slot, tok))
                if sess.done or self._hit_eos(tok):
                    # remaining device steps were masked no-ops
                    done.add(slot)
                    self._finish(slot, sess)
        if self.paged:
            # count only device steps that had >= 1 live lane (trailing
            # all-masked steps move no live pages)
            self.step_kv_blocks.extend(
                b for b, n in zip(kv_blocks, emitted) if n)

    @torch.inference_mode()
    def run(self) -> ContinuousResult:
        """Drive until the queue and slots drain.  Callable repeatedly
        (submit → run → submit → run) with programs reused; see
        ``ContinuousResult`` for cumulative vs per-call fields."""
        fin0 = len(self.finished)
        tick0 = self.tick_count
        pre0 = self.preemptions
        disp0 = self.decode_steps
        arr0 = self.arrivals_released
        hist0 = collections.Counter(self.horizon_hist)
        hd0, hs0 = self.host_dispatch_s, self.host_sync_s
        blk0 = len(self.step_kv_blocks) if self.paged else 0
        pf0, ph0 = self.prefill_tokens, self.prefix_hits
        ps0, cw0 = self.prefix_tokens_saved, self.cow_copies
        st = self.store if self.paged else PageStore  # class-level zeros
        sp0, pr0 = st.pages_spilled, st.pages_restored
        tr0, hp0 = st.tier_restores, st.host_prefix_hits
        sr0, rr0 = st.save_retries, st.restore_retries
        cb0 = st.corrupt_blobs
        qa0, dg0 = self.quarantines, self.degraded_restores
        ab0, fl0 = self.aborted_sessions, self.failed_sessions
        ex0, au0 = self.expired_sessions, self.audit_failures
        rb0 = self.retry_backoff_s
        inj = self.fault_injector
        fired0 = collections.Counter(inj.fired) if inj else None
        limit = self.max_ticks
        if limit is None:
            def ticks_for(s: _Session) -> int:
                # conservative per-token budget (valid for K>1 too)
                t = s.request.max_new_tokens
                if self.paged and self.prefill_chunk:
                    # one tick per chunk; preemption re-prefills all
                    seq = len(s.request.prompt) + s.request.max_new_tokens
                    t += -(-seq // self.prefill_chunk)
                return t
            backlog = list(self.waiting) \
                + [s for _, _, s in self._pending] \
                + [s for _, _, s in self._arrivals]
            budget = sum(ticks_for(s) for s in backlog)
            budget += sum(ticks_for(s)
                          for s in self.slots if s is not None)
            # + one release tick per trace arrival
            limit = (4 + self.restore_patience) * budget \
                + len(self._pending) + len(self._arrivals) + 16
            if self.fault_injector is not None:
                # chaos re-prefills (quarantine, degraded restores) and
                # pressure-spike stall ticks eat extra headroom
                limit += 4 * budget + 64
        t0 = time.perf_counter()
        while self.waiting or self._pending or self._arrivals \
                or any(s is not None for s in self.slots):
            self.tick()
            if self.tick_count - tick0 > limit:
                raise RuntimeError(
                    f"scheduler made no progress within {limit} ticks")
        if self._pressure_holds:
            # a hold outliving the run would leak pool pages
            for _, pages in self._pressure_holds:
                self.store.release(pages)
            self._pressure_holds = []
        wall = time.perf_counter() - t0
        n_tokens = sum(len(s.tokens) for s in self.finished[fin0:])
        sessions = {s.sid: s.to_result() for s in self.finished}
        return ContinuousResult(
            sessions=sessions, ticks=self.tick_count - tick0,
            decode_steps=self.decode_steps, wall_s=wall,
            tokens_per_s=n_tokens / wall if wall > 0 else float("nan"),
            step_cache_size=self.step_cache_size(),
            launches_per_step=self.launches_per_step,
            # snapshot: a returned result must not mutate if the
            # scheduler keeps running (events stays cumulative)
            events=list(self.events),
            preemptions=self.preemptions - pre0,
            step_kv_blocks=(self.step_kv_blocks[blk0:] if self.paged
                            else None),
            steps_per_tick=self.steps_per_tick,
            dispatches=self.decode_steps - disp0,
            run_tokens=n_tokens,
            host_dispatch_s=self.host_dispatch_s - hd0,
            host_sync_s=self.host_sync_s - hs0,
            prefill_tokens=self.prefill_tokens - pf0,
            prefix_hits=self.prefix_hits - ph0,
            prefix_tokens_saved=self.prefix_tokens_saved - ps0,
            cow_copies=self.cow_copies - cw0,
            now_s=self.now_s,
            arrivals=self.arrivals_released - arr0,
            adaptive_k=self.adaptive_k,
            horizon_hist=dict(self.horizon_hist - hist0),
            kv_tier=(self.store.kv_tier if self.paged else "none"),
            tier_policy=(self.store.policy.name
                         if self.tiered else None),
            pages_spilled=st.pages_spilled - sp0,
            pages_restored=st.pages_restored - pr0,
            tier_restores=st.tier_restores - tr0,
            host_prefix_hits=st.host_prefix_hits - hp0,
            host_pages_used=(self.store.host_used if self.paged else 0),
            fault_counts=(
                {k: v for k, v in sorted(
                    (collections.Counter(inj.fired) - fired0).items())
                 if v} if inj else {}),
            faults_injected=(
                sum((collections.Counter(inj.fired) - fired0).values())
                if inj else 0),
            save_retries=st.save_retries - sr0,
            restore_retries=st.restore_retries - rr0,
            degraded_restores=self.degraded_restores - dg0,
            corrupt_blobs=st.corrupt_blobs - cb0,
            quarantines=self.quarantines - qa0,
            aborted_sessions=self.aborted_sessions - ab0,
            failed_sessions=self.failed_sessions - fl0,
            expired_sessions=self.expired_sessions - ex0,
            audit_failures=self.audit_failures - au0,
            retry_backoff_s=self.retry_backoff_s - rb0)
