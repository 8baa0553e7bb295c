"""The port's copies of the framework-neutral serving modules behave as
the JAX package's originals: the page allocator and the prefix index
under the same seeded random walks, the session dataclasses field by
field, the virtual clock's K ladder and adaptive horizon pick, and the
fault-plan, trace and tier-policy modules, whose code is the
reference's statement for statement (only the docstring and the
imports differ)."""
import ast
import dataclasses
import inspect
import random

import numpy as np
import pytest

from repro.serving import faults as jax_faults
from repro.serving import session as jax_session
from repro.serving import trace as jax_trace
from repro.serving import vclock as jax_vclock
from repro.serving.memory import allocator as jax_allocator
from repro.serving.memory import policy as jax_policy
from repro.serving.memory import prefix as jax_prefix
from repro_torch.serving import faults, session, trace, vclock
from repro_torch.serving.memory import allocator, policy, prefix


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


def _body(mod):
    """The module's statements without its docstring and imports."""
    tree = ast.parse(inspect.getsource(mod))
    body = [n for n in tree.body
            if not isinstance(n, (ast.Import, ast.ImportFrom))
            and not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("mod,ref", [(faults, jax_faults), (trace, jax_trace),
                                     (policy, jax_policy)],
                         ids=["faults", "trace", "policy"])
def test_copied_modules_match_statement_for_statement(mod, ref):
    assert _body(mod) == _body(ref)


def test_fault_and_trace_dataclasses_match():
    for mod, ref, names in (
            (faults, jax_faults, ("FaultSpec", "FaultPlanConfig", "FaultPlan")),
            (trace, jax_trace, ("SessionClass", "TraceConfig", "Trace"))):
        for name in names:
            a = [(f.name, str(f.type), repr(f.default))
                 for f in dataclasses.fields(getattr(mod, name))]
            b = [(f.name, str(f.type), repr(f.default))
                 for f in dataclasses.fields(getattr(ref, name))]
            assert a == b, name
    assert faults.KINDS == jax_faults.KINDS


class _Sess:
    def __init__(self, sid, priority, admit_seq, pos, pages):
        self.sid, self.priority, self.admit_seq = sid, priority, admit_seq
        self.pos, self.pages = pos, pages


@pytest.mark.parametrize("seed", range(3))
def test_lookahead_policy_picks_the_same_shadows(seed):
    """``LookAheadSpill.idle_tick`` on the same residents asks both stores
    for the same victim and cold blocks, tick after tick."""
    calls = []
    for mod in (policy, jax_policy):
        rnd = random.Random(seed)
        log = []

        class Store:
            page_size = 4
            shadows: set = set()

            def has_shadow(self, sid, blk):
                return (sid, blk) in self.shadows

            def shadow_spill(self, sid, blks, pages, cache):
                log.append((sid, list(blks), list(pages)))
                self.shadows |= {(sid, b) for b in blks}

        class Sched:
            store = Store()
            cache = None
            slots = [_Sess(f"s{i}", rnd.randint(0, 2), rnd.randint(0, 9),
                           rnd.randint(8, 30), list(range(10 * i, 10 * i + 8)))
                     for i in range(3)] + [None]

        pol = mod.get_policy("lookahead")
        for _ in range(6):
            pol.idle_tick(Sched)
        assert [mod.get_policy(n).name for n in
                ("prefer-device", "spill", "lookahead")] == \
            ["prefer-device", "spill", "lookahead"]
        calls.append(log)
    assert calls[0] == calls[1] and calls[0]
