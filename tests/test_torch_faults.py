"""The port's fault injection and recovery against the JAX package's, on
the CPU.

Mirrors ``tests/test_faults.py``: the plan format (byte-equal to the
reference's text for several (config, seed) pairs, byte-stable round
trips, validation), the injector contract, the tier's guarded copy paths
over fake page movers, and end to end the port's ``SlotScheduler``
against the JAX one under the same plans: every fault kind, the logit
screen at K=1 and K=4, the quarantine budget, the session TTL and a
seeded mixed plan give equal event logs, greedy streams, statuses and
fault counters, fault-free sessions keep the fault-free streams, and
both pools balance.  ``slo_report`` on results with failed sessions
equals the reference's.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving import SessionRequest as JaxRequest
from repro.serving import SlotScheduler as JaxScheduler
from repro.serving import faults as jax_faults
from repro.serving import session as jax_session
from repro.serving import trace as jax_trace
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import (FaultInjector, FaultPlan, FaultPlanConfig,
                                 FaultSpec, InjectedFault, SessionRequest,
                                 SlotScheduler, faults, generate_fault_plan,
                                 plan_from_text, plan_to_text, session,
                                 slo_report, trace, validate_plan)
from repro_torch.serving.faults import KINDS
from repro_torch.serving.memory import TierCopyError, TieredPageStore, get_policy
from repro_torch.serving.memory.allocator import BlockAllocator

SHAPE = dict(vocab_size=64, d_model=64, d_ff=128, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, dtype="float32")
COUNTERS = ("ticks", "decode_steps", "preemptions", "prefill_tokens",
            "now_s", "pages_spilled", "pages_restored", "tier_restores",
            "host_prefix_hits", "host_pages_used", "fault_counts",
            "faults_injected", "save_retries", "restore_retries",
            "degraded_restores", "corrupt_blobs", "quarantines",
            "aborted_sessions", "failed_sessions", "expired_sessions",
            "audit_failures", "retry_backoff_s", "horizon_hist")


# ---------------------------------------------------------- plan format
PLAN_CASES = [
    (dict(seed=0, n_faults=10, horizon_s=0.5), ("a", "b", "c")),
    (dict(seed=7, n_faults=12, horizon_s=1.0), ()),
    (dict(seed=123, n_faults=20, horizon_s=0.3, max_count=5,
          max_duration_s=0.2), ("s0", "s1")),
    (dict(seed=5, n_faults=8, horizon_s=2.0,
          kinds=("nan_logits", "abort", "pool_pressure")), ("x", "y")),
]


@pytest.mark.parametrize("cfg,sids", PLAN_CASES)
def test_plan_text_is_byte_equal_to_the_reference(cfg, sids):
    txt = plan_to_text(generate_fault_plan(FaultPlanConfig(**cfg), sids))
    ref = jax_faults.plan_to_text(jax_faults.generate_fault_plan(
        jax_faults.FaultPlanConfig(**cfg), sids))
    assert txt == ref
    plan = plan_from_text(txt)
    assert plan_to_text(plan) == txt
    assert plan == generate_fault_plan(FaultPlanConfig(**cfg), sids)
    times = [s.at_s for s in plan.specs]
    assert times == sorted(times)


def test_same_seed_same_plan():
    cfg = FaultPlanConfig(seed=5, n_faults=12, horizon_s=1.0)
    a = generate_fault_plan(cfg, session_ids=("x", "y"))
    assert a == generate_fault_plan(cfg, session_ids=("x", "y"))
    assert a != generate_fault_plan(
        FaultPlanConfig(seed=6, n_faults=12, horizon_s=1.0), ("x", "y"))


@pytest.mark.parametrize("spec,msg", [
    (FaultSpec("meteor", 0.1), "unknown kind"),
    (FaultSpec("abort", -0.1), "negative due time"),
    (FaultSpec("abort", 0.1, count=0), "must be >= 1"),
    (FaultSpec("pool_pressure", 0.1), "positive hold duration"),
    (FaultSpec("abort", 0.1, target="a b"), "must be a token"),
])
def test_validate_rejects_bad_specs(spec, msg):
    with pytest.raises(ValueError, match=msg):
        validate_plan(FaultPlan(FaultPlanConfig(), (spec,)))


def test_validate_rejects_unsorted_and_parse_requires_header():
    with pytest.raises(ValueError, match="time-sorted"):
        validate_plan(FaultPlan(FaultPlanConfig(), (
            FaultSpec("abort", 0.2), FaultSpec("abort", 0.1))))
    with pytest.raises(AssertionError, match="header"):
        plan_from_text("abort t=0.100000 target=- count=1 dur=0.000000\n")


# ------------------------------------------------------------- injector
def test_injector_walk_matches_the_reference():
    """Poll a generated plan at rising times, draw copy failures and
    mark scheduler-applied kinds: both injectors return the same specs,
    budgets and counters."""
    logs = []
    for f in (jax_faults, faults):
        inj = f.FaultInjector(f.generate_fault_plan(
            f.FaultPlanConfig(seed=11, n_faults=30, horizon_s=1.0), ("a", "b")))
        log = [inj.scheduled]
        for t in np.linspace(0, 1.1, 23):
            due = inj.poll(float(t))
            log.append([(s.kind, s.at_s, s.target, s.count, s.duration_s)
                        for s in due])
            for s in due:
                inj.mark(s.kind)
            log.append((inj.take_copy_fail("save"),
                        inj.take_copy_fail("restore"),
                        inj.save_fails, inj.restore_fails, inj.counters()))
        logs.append(log)
    assert logs[0] == logs[1]


class TestInjector:
    def _plan(self):
        return FaultPlan(FaultPlanConfig(), (
            FaultSpec("save_fail", 0.1, count=2),
            FaultSpec("nan_logits", 0.2, target="s0"),
            FaultSpec("pool_pressure", 0.3, count=2, duration_s=0.01)))

    def test_poll_activates_in_time_order(self):
        inj = FaultInjector(self._plan())
        assert inj.scheduled == 3
        assert inj.poll(0.05) == []
        assert inj.poll(0.1) == [] and inj.save_fails == 2
        assert [s.kind for s in inj.poll(0.25)] == ["nan_logits"]
        assert [s.kind for s in inj.poll(10.0)] == ["pool_pressure"]
        assert inj.poll(20.0) == []

    def test_copy_fail_budget_is_consumable(self):
        inj = FaultInjector(self._plan())
        inj.poll(0.15)
        assert inj.take_copy_fail("save") and inj.take_copy_fail("save")
        assert not inj.take_copy_fail("save")
        assert not inj.take_copy_fail("restore")
        assert inj.fired["save_fail"] == 2

    def test_counters_are_stable_keyed(self):
        inj = FaultInjector(self._plan())
        for k in ("abort", "abort", "nan_logits"):
            inj.mark(k)
        assert inj.counters() == {"nan_logits": 1, "abort": 2}
        assert all(k in KINDS for k in inj.counters())


# ------------------------------------------- tier copy guards (unit)
def _flaky_store(fail_saves=0, fail_restores=0, **kw):
    """TieredPageStore over fake movers that fail the first N calls;
    blobs are (page_id,) sentinels."""
    state = {"fs": fail_saves, "fr": fail_restores, "restored": []}

    def save_fn(cache, pages):
        if state["fs"] > 0:
            state["fs"] -= 1
            raise InjectedFault("save transport fault")
        return [(torch.full((1,), float(p)), torch.zeros(1)) for p in pages]

    def restore_fn(cache, pages, blobs):
        if state["fr"] > 0:
            state["fr"] -= 1
            raise InjectedFault("restore transport fault")
        state["restored"].extend((int(b[0][0]), p) for p, b in zip(pages, blobs))
        return cache

    store = TieredPageStore(
        n_slots=2, max_blocks=6, page_size=4, n_pages=10, prefix_cache=True,
        host_pages=kw.pop("host_pages", 8),
        policy=get_policy(kw.pop("policy", "spill")),
        retry_budget=kw.pop("retry_budget", 2),
        save_fn=save_fn, restore_fn=restore_fn, get_cache=lambda: {}, **kw)
    return store, state


def _parked(store):
    pages = store.alloc(2)
    store.park("sid", 2, pages, {})
    store.release(pages)
    return pages


class TestTierGuards:
    def test_save_retry_within_budget(self):
        store, _ = _flaky_store(fail_saves=1)
        _parked(store)
        assert store.save_retries == 1
        assert store.parked_blocks("sid") == 2 and store.host_used == 2
        fresh = store.alloc(2)
        store.take_parked("sid", 0, fresh, {})
        store.release(fresh)
        assert store.host_used == 0
        assert store.allocator.n_free == store.n_pages - 1

    def test_save_past_budget_degrades_clean(self):
        store, _ = _flaky_store(fail_saves=10, retry_budget=1)
        pages = store.alloc(2)
        assert store.park("sid", 2, pages, {}) is None
        assert store.park_fails == 1 and store.save_retries == 1
        assert store.parked_blocks("sid") == 0 and store.host_used == 0
        store.release(pages)
        assert store.allocator.n_free == store.n_pages - 1

    def test_restore_fail_keeps_entry_and_unwind_balances(self):
        store, _ = _flaky_store(fail_restores=10, retry_budget=1)
        _parked(store)
        fresh = store.alloc(2)
        with pytest.raises(TierCopyError, match="failed after"):
            store.take_parked("sid", 0, fresh, {})
        assert store.restore_retries == 1
        assert store.parked_blocks("sid") == 2 and store.host_used == 2
        store.release(fresh)
        store.drop_parked("sid")
        assert store.host_used == 0
        assert store.allocator.n_free == store.n_pages - 1

    def test_restore_retry_within_budget(self):
        store, state = _flaky_store(fail_restores=1)
        pages = _parked(store)
        fresh = store.alloc(2)
        store.take_parked("sid", 0, fresh, {})
        assert store.restore_retries == 1 and store.tier_restores == 1
        assert [m[0] for m in state["restored"]] == pages
        store.release(fresh)
        assert store.host_used == 0

    @pytest.mark.parametrize("verify", [True, False])
    def test_corrupt_parked_blob_and_the_checksum_screen(self, verify):
        store, _ = _flaky_store(verify_checksums=verify)
        _parked(store)
        assert store.corrupt_parked_blob() == "sid"
        fresh = store.alloc(2)
        if verify:
            with pytest.raises(TierCopyError, match="verify-on-restore"):
                store.take_parked("sid", 0, fresh, {})
            assert store.corrupt_blobs == 1
            store.drop_parked("sid")
        else:
            store.take_parked("sid", 0, fresh, {})
            assert store.corrupt_blobs == 0 and store.tier_restores == 1
        store.release(fresh)
        assert store.host_used == 0
        assert store.allocator.n_free == store.n_pages - 1

    def test_corrupt_host_prefix_blob_is_purged(self):
        store, _ = _flaky_store()
        seq = np.asarray([5] * 8, np.int32)
        pages = store.alloc(2)
        store.register(seq, pages, 2)
        store.release(pages)
        store.prefix.reclaim(99)
        paths = store.host_match(seq, 0, 2)
        assert len(paths) == 2
        h = store._hpath[paths[0]]
        bad = store.host.get(h)[0].clone()
        bad.view(torch.uint8)[0] ^= 0xFF
        store.host.replace(h, (bad,) + tuple(store.host.get(h)[1:]))
        fresh = store.alloc(2)
        with pytest.raises(TierCopyError, match="checksum"):
            store.restore_host_prefix(paths, fresh, {})
        assert store.corrupt_blobs >= 1
        assert store.host_match(seq, 0, 2) == []
        store.release(fresh)
        store.flush_host()
        assert store.host_used == 0


# ----------------------------------------------- scheduler against JAX
@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    cfg = get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(11))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             "cpu")
    return JaxModel(jcfg), jparams, Model(cfg, device="cpu"), params


def _reqs(n=5):
    rng = np.random.RandomState(3)
    return [(f"s{i}", rng.randint(0, 64, size=8 + 3 * (i % 3)).astype(np.int32),
             6 + 2 * (i % 2)) for i in range(n)]


def _serve(models, reqs, plan_text=None, k=1, **kw):
    """The same requests and plan through the JAX scheduler and the
    port's (tiered, prefix cache on, a thrashing pool); equal events,
    streams, statuses and counters.  Returns (port scheduler, result)."""
    jm, jparams, model, params = models
    kw = dict(dict(n_slots=2, max_len=24, paged=True, page_size=4, n_pages=8,
                   prefill_chunk=4, prefix_cache=True, kv_tier="host",
                   tier_policy="spill", host_pages=16, steps_per_tick=k,
                   timed=False), **kw)
    audit = plan_text is not None
    ref_s = JaxScheduler(jm, jparams, shared_programs=True, self_audit=audit,
                         fault_injector=(jax_faults.FaultInjector(
                             jax_faults.plan_from_text(plan_text))
                             if audit else None), **kw)
    sched = SlotScheduler(model, params, self_audit=audit,
                          fault_injector=(FaultInjector(plan_from_text(plan_text))
                                          if audit else None), **kw)
    for r in reqs:
        ref_s.submit(JaxRequest(*r))
        sched.submit(SessionRequest(*r))
    ref, got = ref_s.run(), sched.run()
    assert got.events == ref.events
    for sid, a in ref.sessions.items():
        b = got.sessions[sid]
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=sid)
        assert b.status == a.status, sid
    for field in COUNTERS:
        assert getattr(got, field) == getattr(ref, field), field
    n_pages = sched.store.n_pages
    sched.flush_prefix_cache()
    sched.store.flush_host()
    assert sched.store.allocator.n_free == n_pages - 1, "device page leak"
    assert sched.store.host_used == 0, "host blob leak"
    assert not sched._pressure_holds
    return sched, got


@pytest.fixture(scope="module")
def baseline(models):
    """Fault-free streams at K=1 and K=4 (checked against JAX too)."""
    out = {}
    for k in (1, 4):
        _, res = _serve(models, _reqs(), k=k)
        assert res.preemptions > 0, "pool never thrashed: tests inert"
        assert not res.fault_counts and res.quarantines == 0
        out[k] = {sid: s.tokens for sid, s in res.sessions.items()}
    return out


def _plan(*specs):
    return plan_to_text(FaultPlan(FaultPlanConfig(), tuple(
        FaultSpec(*s) for s in specs)))


CASES = {
    # name: (plan specs, k, scheduler kwargs, what must have happened)
    "restore_fail_storm": ([("restore_fail", 0.0, "", 500)], 1,
                           dict(retry_budget=1), "degraded_restores"),
    "save_fail": ([("save_fail", 0.0, "", 1)], 1, {}, "save_retries"),
    # prefix cache off: a device prefix match would supersede the
    # damaged parked copy before its checksum is read
    "blob_corrupt": ([("blob_corrupt", 0.0, "", 1)], 1,
                     dict(prefix_cache=False), "corrupt_blobs"),
    "pool_pressure": ([("pool_pressure", 0.0, "", 3, 0.02)], 1, {}, None),
    "nan_k1": ([("nan_logits", 0.0, "s0")], 1, {}, "quarantines"),
    "nan_k4": ([("nan_logits", 0.0, "s0")], 4, {}, "quarantines"),
    "nan_any": ([("nan_logits", 0.05, "")], 1, {}, "quarantines"),
    "quarantine_budget_0": ([("nan_logits", 0.0, "s1")], 1,
                            dict(quarantine_budget=0), "failed_sessions"),
    "abort_target": ([("abort", 0.0, "s2")], 1, {}, "aborted_sessions"),
    "abort_any": ([("abort", 0.03, "")], 4, {}, "aborted_sessions"),
    "ttl": ([], 1, dict(session_ttl_s=0.01), "expired_sessions"),
    "logit_screen_clean": ([], 1, dict(logit_screen=True), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_recovery_matches_the_reference(models, baseline, name):
    """Each fault kind against the JAX scheduler; sessions that end ok
    keep the fault-free streams, and a session ended early kept a prefix
    of its stream."""
    specs, k, kw, fired = CASES[name]
    sched, res = _serve(models, _reqs(), _plan(*specs), k=k, **kw)
    if fired:
        assert getattr(res, fired) > 0, f"{name}: nothing was tested"
    if name == "pool_pressure":
        assert any(e[0] == "pressure" for e in res.events)
    for sid, toks in baseline[k].items():
        got = res.sessions[sid]
        if got.status == "ok":
            np.testing.assert_array_equal(got.tokens, toks, err_msg=sid)
        else:
            np.testing.assert_array_equal(got.tokens, toks[:len(got.tokens)])


@pytest.mark.parametrize("seed,k", [(3, 1), (7, 4), (11, 1)])
def test_mixed_plan_matches_the_reference(models, seed, k):
    """A seeded plan over every fault kind, as ``serve --fault-plan
    mixed`` builds one."""
    reqs = _reqs()
    text = plan_to_text(generate_fault_plan(
        FaultPlanConfig(seed=seed, n_faults=10, horizon_s=0.3),
        session_ids=[r[0] for r in reqs]))
    _, res = _serve(models, reqs, text, k=k)
    assert res.faults_injected > 0


def test_audit_warns_then_fails_closed(models):
    sched, _ = _serve(models, _reqs(2), _plan())
    sched.flush_prefix_cache()
    sched.store.allocator._refs[1] += 1      # damage: a free page held
    sched._run_audit()
    assert sched.audit_failures == 1
    assert any(e[0] == "audit" for e in sched.events)
    with pytest.raises(RuntimeError, match="audit failed twice"):
        sched._run_audit()


def test_allocator_check_detects_refcount_damage():
    alloc = BlockAllocator(6)
    pages = alloc.alloc(2)
    alloc._refs[pages[0]] = 0
    assert any("refcount 0 but not free" in i for i in alloc.check())
    alloc._refs[pages[0]] = 1
    alloc.release(pages)
    assert alloc.check() == []


# ---------------------------------------------- slo_report accounting
def _result(sess_mod, specs):
    out = {}
    for sid, n, status, gap in specs:
        times = 0.01 * np.arange(1, n + 1) * (gap / 0.01)
        out[sid] = sess_mod.SessionResult(
            session_id=sid, tokens=np.arange(n, dtype=np.int32), slot=0,
            admitted_tick=0, finished_tick=1, step_times_s=[], klass="chat",
            status=status, arrival_s=0.0, token_times_s=times,
            ttft_s=float(times[0]) if n else None)
    return sess_mod.ContinuousResult(
        sessions=out, ticks=1, decode_steps=1, wall_s=0.1, tokens_per_s=1.0,
        step_cache_size=0, launches_per_step=1, events=[])


@pytest.mark.parametrize("specs", [
    [("a", 8, "ok", 0.01), ("b", 8, "ok", 0.01), ("x", 3, "aborted", 9.0)],
    [("x", 2, "expired", 0.01), ("y", 0, "failed", 0.01)],
    [("a", 8, "ok", 0.01), ("b", 8, "ok", 0.2)],
])
def test_slo_report_with_failed_sessions_matches_the_reference(specs):
    rep = slo_report(_result(session, specs),
                     {"chat": trace.SessionClass("chat", 1.0, slo_ttft_s=0.5,
                                                 slo_tpot_s=0.05)})
    ref = jax_trace.slo_report(
        _result(jax_session, specs),
        {"chat": jax_trace.SessionClass("chat", 1.0, slo_ttft_s=0.5,
                                        slo_tpot_s=0.05)})
    assert rep == ref
    json.dumps(rep, allow_nan=False)
