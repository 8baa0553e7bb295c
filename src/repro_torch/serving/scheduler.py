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
executor instead (contiguous slots only, as in the reference).  Prefill, the page copy and the cache are written
in place, and each program returns the same cache dict.

Sampling draws from a ``torch.Generator`` seeded with ``seed``; greedy
streams are the contract, stochastic draws do not follow the
reference's keys.  The host-DRAM KV tier (``kv_tier="host"``) and fault
injection wait for their slices.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import MODES, launch_count
from repro_torch.models.model import Model
from repro_torch.serving.memory import BlockAllocator, PageStore, PrefixCache
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
                 adaptive_k: bool = False, kv_tier: str = "none",
                 fault_injector=None):
        if kv_tier != "none":
            raise NotImplementedError(
                "the host-DRAM KV tier (kv_tier='host') arrives with the "
                "host-tier slice")
        if fault_injector is not None:
            raise NotImplementedError(
                "fault injection arrives with the fault-injection slice")
        if n_slots < 1 or steps_per_tick < 1:
            raise ValueError(f"bad n_slots={n_slots} / steps_per_tick="
                             f"{steps_per_tick}")
        if dispatch_mode not in MODES:
            raise ValueError(f"dispatch_mode must be one of {MODES}, got "
                             f"{dispatch_mode!r}")
        if adaptive_k and steps_per_tick < 2:
            raise NotImplementedError(
                "adaptive_k needs a horizon ceiling >= 2 to adapt below")
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
        self.min_steps_per_tick = 1
        self.k_ladder: Tuple[int, ...] = build_k_ladder(steps_per_tick, 1)
        # virtual clock (the reference's defaults): launch tax per
        # dispatch + service quantum per decode step; deterministic host
        # arithmetic that paces arrivals and the adaptive horizon
        self.virtual_step_s = 1e-3
        self.virtual_dispatch_s = 4e-3
        self.now_s = 0.0
        self._pending: List[Tuple[float, int, _Session]] = []
        self._arrivals: List[Tuple[float, int, _Session]] = []
        self._arrival_seq = 0
        self.arrivals_released = 0
        self.horizon_hist: collections.Counter = collections.Counter()

        self._progs = SchedulerPrograms(
            model, paged=paged, steps_per_tick=steps_per_tick,
            temperature=temperature)
        self.paged = paged
        if prefix_cache and not paged:
            raise NotImplementedError(
                "prefix sharing rides the paged block table")
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
            self.store: Optional[PageStore] = PageStore(
                n_slots=n_slots, max_blocks=self.max_blocks,
                page_size=page_size, n_pages=n_pages,
                prefix_cache=prefix_cache)
        else:
            self.cache = model.init_cache(n_slots, max_len,
                                          kv_dtype=kv_dtype, slotted=True)
            self.store = None

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
            self._release_slot(slot, sess)
        self.events.append(("finish", sess.sid, slot))

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

    def _preempt(self, slot: int, sess: _Session) -> None:
        """Requeue a session at the head of the queue to reclaim its
        pages; it re-prefills its prompt and generated prefix on
        re-admission.  Costs recompute, never correctness."""
        self._release_slot(slot, sess)
        self.slots[slot] = None
        sess.slot = -1
        sess.prefilled = 0
        sess.prefill_seq = None
        sess.resume = True
        self.waiting.appendleft(sess)   # it was admitted before the waiters
        self.preemptions += 1
        self.events.append(("preempt", sess.sid, slot))

    def _alloc_or_preempt(self, n: int, needy: _Session) -> Optional[List[int]]:
        """Allocate ``n`` pages, preempting one victim at a time until
        it fits (None if it still can't).  Victims: lowest-priority-
        youngest first."""
        while True:
            got = self.store.alloc(n)
            if got is not None:
                return got
            victims = [((-s.priority, s.admit_seq), i, s)
                       for i, s in enumerate(self.slots)
                       if s is not None and s is not needy
                       and (s.priority < needy.priority
                            or (s.priority == needy.priority
                                and s.admit_seq > needy.admit_seq))]
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

    def _backfill_paged(self) -> None:
        """FIFO admission gated on free pages (head-of-line blocking is
        deliberate — skip-ahead would starve long prompts).  The gate
        charges only the UNMATCHED pages, counting reclaimable cached
        pages as free — excluding the match itself, which is about to be
        pinned."""
        for slot in range(self.n_slots):
            while self.slots[slot] is None and self.waiting:
                head = self.waiting[0]
                seq = self._prefill_seq_for(head)
                shared = self.store.match(seq)
                while True:
                    matched = len(shared) * self.page_size
                    if shared and matched >= len(seq):
                        # fully cached: fresh needs 1 page (the CoW copy)
                        # pinning shared[:-1]; resume pins the whole
                        # match, +1 decode-write headroom
                        resume = head.resume and head.tokens
                        pinned = shared if resume else shared[:-1]
                        need = 1
                    else:
                        pinned = shared
                        tail = len(seq) - matched
                        first = (tail if self.prefill_chunk is None
                                 else min(self.prefill_chunk, tail))
                        need = self._pages_for(matched + first) - len(shared)
                    if self.store.can_cover(need, pinned):
                        break
                    if not shared:
                        return      # gate: wait for reclaim
                    # shrink the match: its dropped tail pages become
                    # reclaimable fuel for this admission (degrades to
                    # the unshared gate = liveness)
                    shared = shared[:-1]
                self._admit_paged(slot, self.waiting.popleft(), seq, shared)
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
        """One iteration: continue chunked prefills, backfill, one batched
        decode dispatch, evict completed sessions."""
        n_before = len(self.events)
        self._release_arrivals()
        if self.paged:
            for slot, sess in enumerate(self.slots):
                if sess is not None and not sess.decoding:
                    self._prefill_next_chunk(slot, sess)
        self._backfill()
        if self.steps_per_tick == 1:
            self._decode_tick_single()
        else:
            self._decode_tick_horizon(self._tick_horizon())
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
        for slot, sess in active:
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
        tok_mat = np.asarray(tok_mat.cpu())
        t2 = time.perf_counter()
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
            limit = 4 * budget + len(self._pending) + len(self._arrivals) + 16
        t0 = time.perf_counter()
        while self.waiting or self._pending or self._arrivals \
                or any(s is not None for s in self.slots):
            self.tick()
            if self.tick_count - tick0 > limit:
                raise RuntimeError(
                    f"scheduler made no progress within {limit} ticks")
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
            horizon_hist=dict(self.horizon_hist - hist0))
