"""Pluggable placement/migration policies for the host-DRAM KV tier.

A ``TierPolicy`` decides *what spills and when*; the mechanism (batched
device↔host page copies, the host pool, restore-on-resume) lives in
``TieredPageStore`` and is policy-independent.  Policies steer three
hooks:

  * ``spill_parked`` — park a preempted session's full KV pages
    host-side (vs the single-tier behaviour: destroy and re-prefill).
  * ``spill_prefix`` — give LRU-evicted prefix-cache pages a second
    life in the host prefix index.
  * ``idle_tick(sched)`` — optional background migration run by the
    scheduler on ticks with no admission pressure; ``LookAheadSpill``
    uses it to pre-copy the predicted next preemption victim's cold
    pages so the eventual park is (near) copy-free on the critical
    path.

Policies only change *schedules and copies*, never streams: greedy
token identity versus the single-tier baseline holds under every
policy (asserted in tests/test_torch_kv_tiering.py and on the card in
chip_smoke.py's phase 9b).  A copy of ``repro.serving.memory.policy``.
"""
from __future__ import annotations


class TierPolicy:
    """Base policy: what the host tier accepts and when it pre-copies."""

    name = "base"
    spill_parked = True
    spill_prefix = True

    def idle_tick(self, sched) -> None:
        """Background-migration hook; called by the scheduler on ticks
        with no waiting arrivals.  Default: nothing."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class PreferDevice(TierPolicy):
    """Control arm: the host pool exists but nothing is ever placed in
    it — preemption destroys KV and resume re-prefills, byte-for-byte
    the single-tier scheduler.  A/B against this to isolate the tier's
    contribution."""

    name = "prefer-device"
    spill_parked = False
    spill_prefix = False


class SpillOnEvict(TierPolicy):
    """Default reactive policy: migrate exactly when the device tier
    gives a page up — park full pages at preemption, index prefix pages
    at LRU eviction.  No background copies, so every spill is on the
    preemption path and charged there."""

    name = "spill"


class LookAheadSpill(SpillOnEvict):
    """Reactive spilling plus look-ahead pre-copies (the LookAhead
    placement idiom from the data-placement simulators this tier
    mirrors): on idle ticks, shadow-copy up to ``budget`` cold full
    pages of the session the preemption rule would pick next — lowest
    priority, youngest admission, the exact ordering ``_preempt``
    uses — so when that preemption lands, park only copies the
    un-shadowed remainder.  Cold full pages are immutable (decode
    writes only at ``pos``), so shadows never go stale; if the victim
    finishes instead, its shadows are dropped."""

    name = "lookahead"

    def __init__(self, budget: int = 2):
        self.budget = budget

    def idle_tick(self, sched) -> None:
        store = sched.store
        live = [s for s in sched.slots if s is not None and s.pages]
        if not live:
            return
        victim = max(live, key=lambda s: (-s.priority, s.admit_seq))
        n_full = victim.pos // store.page_size
        blks = [b for b in range(n_full)
                if not store.has_shadow(victim.sid, b)][:self.budget]
        if blks:
            store.shadow_spill(victim.sid, blks,
                               [victim.pages[b] for b in blks],
                               sched.cache)

    def __repr__(self) -> str:
        return f"LookAheadSpill(budget={self.budget})"


_POLICIES = {
    "prefer-device": PreferDevice,
    "spill": SpillOnEvict,
    "lookahead": LookAheadSpill,
}


def get_policy(name) -> TierPolicy:
    """Resolve a policy by CLI name (an already-built policy instance
    passes through, so tests can inject configured ones)."""
    if isinstance(name, TierPolicy):
        return name
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown tier policy {name!r}; "
            f"choose from {sorted(_POLICIES)}") from None
