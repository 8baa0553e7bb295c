"""Virtual-clock pacing for trace-driven serving.

``VirtualClockMixin`` carries the deterministic cost model the
scheduler charges against — a launch tax per dispatched program, a
service quantum per device decode step, a host-copy quantum per
migrated KV page — plus trace-arrival release and the adaptive-K
horizon pick (which is clock-driven: macro-ticks end at the next
scheduling event).  Pure host arithmetic; nothing here touches the
device.  A copy of ``repro.serving.vclock``, held equal in behaviour to
it by ``tests/test_torch_serving_copies.py``.
"""
from __future__ import annotations

import heapq
import time
from typing import Optional, Tuple


def build_k_ladder(ceiling: int, floor: int) -> Tuple[int, ...]:
    """Halvings of the horizon ceiling down to the floor — one
    (backend, K) executable per rung, ever."""
    ladder = set()
    k = ceiling
    while k > floor:
        ladder.add(k)
        k //= 2
    ladder.add(floor)
    return tuple(sorted(ladder))


class VirtualClockMixin:
    """Clock/pacing methods mixed into ``SlotScheduler``.

    Uses scheduler state: ``now_s``, ``virtual_*_s``, ``timed``,
    ``_pending``/``_arrivals``, ``waiting``, ``slots``, ``paged``,
    ``adaptive_k``, ``steps_per_tick``, ``k_ladder``."""

    def _release_arrivals(self) -> None:
        """Release due trace requests; fast-forward the clock to the
        next arrival when the whole system is idle."""
        if self._pending:
            base = self.now_s
            for rel, seq, sess in self._pending:
                sess.arrival_s = base + rel
                heapq.heappush(self._arrivals, (base + rel, seq, sess))
            self._pending.clear()
        if self._arrivals and not self.waiting \
                and all(s is None for s in self.slots):
            self.now_s = max(self.now_s, self._arrivals[0][0])
        while self._arrivals and self._arrivals[0][0] <= self.now_s:
            _, _, sess = heapq.heappop(self._arrivals)
            sess.release_wall = time.perf_counter() if self.timed else None
            self.waiting.append(sess)
            self.arrivals_released += 1

    def _charge(self, steps: int, dispatches: int = 1) -> None:
        """Advance the clock: launch taxes + device service quanta."""
        self.now_s += (dispatches * self.virtual_dispatch_s
                       + steps * self.virtual_step_s)

    def _charge_migration(self, n_pages: int) -> None:
        """One batched KV-page migration: a launch tax plus a host-copy
        quantum per page (the tier's A/B currency — see table14)."""
        self.now_s += (self.virtual_dispatch_s
                       + n_pages * self.virtual_host_copy_s)

    def _stamp(self, sess, vt: Optional[float] = None) -> None:
        """Record the emission time of the token just appended."""
        sess.token_times_s.append(self.now_s if vt is None else vt)
        if self.timed and sess.first_token_wall is None \
                and len(sess.tokens) == 1:
            sess.first_token_wall = time.perf_counter()

    def _tick_horizon(self) -> int:
        """Horizon K for this macro-tick.  Fixed-K uses the ceiling;
        adaptive-K ends macro-ticks at the next *scheduling event*:
        shortest remaining budget when someone waits against full
        slots, never past an arrival that could fill a free slot, else
        the ladder top.  Only ladder rungs dispatch."""
        if not self.adaptive_k:
            return self.steps_per_tick
        k = self.steps_per_tick
        remaining = [s.request.max_new_tokens - len(s.tokens)
                     for s in self.slots
                     if s is not None and (not self.paged or s.decoding)]
        slots_full = all(s is not None for s in self.slots)
        if remaining:
            demand = bool(self.waiting) or bool(self._arrivals)
            k = min(k, min(remaining) if demand and slots_full
                    else max(remaining))
        if self._arrivals and not slots_full:
            # steps until the next arrival is due; +1 so an arrival
            # inside the next quantum still lets one step run
            until = self._arrivals[0][0] - self.now_s
            k = min(k, 1 + int(max(until, 0.0) / self.virtual_step_s))
        k = max(k, self.min_steps_per_tick)
        for rung in reversed(self.k_ladder):
            if rung <= k:
                return rung
        return self.min_steps_per_tick
