"""The port's copies of the framework-neutral serving modules behave as
the JAX package's originals: the page allocator and the prefix index
under the same seeded random walks, the session dataclasses field by
field, and the virtual clock's K ladder and adaptive horizon pick."""
import dataclasses
import random

import numpy as np
import pytest

from repro.serving import session as jax_session
from repro.serving import vclock as jax_vclock
from repro.serving.memory import allocator as jax_allocator
from repro.serving.memory import prefix as jax_prefix
from repro_torch.serving import session, vclock
from repro_torch.serving.memory import allocator, prefix


def _walk(mods, seed, steps=300, n_pages=24, page=4):
    """Drive an allocator + prefix cache of each module pair through the
    same random operations; returns each side's observation log."""
    logs = []
    for alloc_mod, prefix_mod in mods:
        rnd = random.Random(seed)
        al = alloc_mod.BlockAllocator(n_pages)
        pc = prefix_mod.PrefixCache(al)
        held, log = [], []
        vocab = 5
        for _ in range(steps):
            op = rnd.choice(["alloc", "release", "register", "match",
                             "reclaim", "retain"])
            if op == "alloc":
                got = al.alloc(rnd.randint(1, 4))
                log.append(("alloc", got))
                if got:
                    held.append(got)
            elif op == "release" and held:
                pages = held.pop(rnd.randrange(len(held)))
                al.release(pages)
                log.append(("release", pages))
            elif op == "retain" and held:
                pages = held[rnd.randrange(len(held))]
                al.retain(pages)
                held.append(list(pages))
                log.append(("retain", pages))
            elif op == "register" and held:
                pages = held[rnd.randrange(len(held))]
                toks = np.asarray([rnd.randrange(vocab)
                                   for _ in range(len(pages) * page)], np.int32)
                pc.register(toks, page, pages, len(pages))
                log.append(("register", pc.pages()))
            elif op == "match":
                toks = np.asarray([rnd.randrange(vocab) for _ in range(3 * page)],
                                  np.int32)
                log.append(("match", pc.match(toks, page)))
            elif op == "reclaim":
                log.append(("reclaim", pc.reclaimable(), pc.reclaim(rnd.randint(0, 3))))
            log.append((al.n_free, [al.refcount(p) for p in range(n_pages)],
                        al.check(), pc.check(), len(pc)))
        log.append(("flush", pc.flush(), al.n_free))
        logs.append(log)
    return logs


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_prefix_cache_walks_match(seed):
    ref, got = _walk([(jax_allocator, jax_prefix), (allocator, prefix)], seed)
    assert got == ref
    assert allocator.GARBAGE_PAGE == jax_allocator.GARBAGE_PAGE


def test_session_dataclasses_match():
    for name in ("SessionRequest", "SessionResult", "ContinuousResult",
                 "_Session"):
        a = [(f.name, str(f.type), f.default)
             for f in dataclasses.fields(getattr(session, name))]
        b = [(f.name, str(f.type), f.default)
             for f in dataclasses.fields(getattr(jax_session, name))]
        assert a == b, name
    req = (session.SessionRequest("s", np.arange(3), 4, priority=2),
           jax_session.SessionRequest("s", np.arange(3), 4, priority=2))
    results = []
    for mod, r in zip((session, jax_session), req):
        s = mod._Session(r, tokens=[5, 6], slot=1, admitted_tick=2,
                         finished_tick=7, token_times_s=[0.5, 0.75],
                         arrival_s=0.25, prefill_seq=np.arange(3), prefilled=3)
        assert s.decoding and s.next_input_token == 6 and not s.done
        res = dataclasses.asdict(s.to_result())
        results.append({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in res.items()})
    assert results[0] == results[1]


class _Clock:
    """The scheduler state the virtual-clock mixin reads."""

    def __init__(self, mixin, rnd):
        self.mixin = mixin
        self.steps_per_tick = rnd.choice([2, 4, 8, 16])
        self.min_steps_per_tick = 1
        self.k_ladder = mixin.build_k_ladder(self.steps_per_tick, 1)
        self.adaptive_k, self.paged = True, rnd.random() < 0.5
        self.now_s, self.virtual_step_s = rnd.random(), 1e-3
        self.waiting = [0] * rnd.randint(0, 2)
        self._arrivals = ([(self.now_s + rnd.random() * 0.01, 0, None)]
                          if rnd.random() < 0.5 else [])

        class S:
            def __init__(self, n, budget):
                self.tokens, self.decoding = [0] * n, True
                self.request = type("R", (), {"max_new_tokens": budget})
        self.slots = [S(rnd.randint(0, 5), 9) if rnd.random() < 0.7 else None
                      for _ in range(3)]


@pytest.mark.parametrize("seed", range(3))
def test_virtual_clock_matches(seed):
    for ceiling, floor in [(16, 1), (8, 2), (5, 1), (1, 1)]:
        assert vclock.build_k_ladder(ceiling, floor) == \
            jax_vclock.build_k_ladder(ceiling, floor)
    for i in range(50):
        picks = []
        for mod in (vclock, jax_vclock):
            st = _Clock(mod, random.Random(seed * 100 + i))
            picks.append(mod.VirtualClockMixin._tick_horizon(st))
        assert picks[0] == picks[1]
