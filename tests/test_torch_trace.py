"""The port's trace replay and SLO reports against the JAX package's, on
the CPU.

Mirrors ``tests/test_trace.py``: seeded traces are byte-equal to the
reference's text, the checked-in golden trace regenerates byte for byte
through the port, validation rejects what the reference rejects, and a
replay through the port's ``SlotScheduler`` gives the JAX scheduler's
event log, virtual stamps and ``slo_report`` — under fixed K, adaptive
K, both preemption orders, and with the host tier and a fault plan on.
"""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving import SlotScheduler as JaxScheduler
from repro.serving import faults as jax_faults
from repro.serving import trace as jax_trace
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import (FaultInjector, FaultPlanConfig,
                                 SessionRequest, SlotScheduler, bursty_config,
                                 generate_fault_plan, generate_trace,
                                 plan_from_text, plan_to_text, poisson_config,
                                 slo_report, trace_from_text, trace_to_text,
                                 validate_trace)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "trace_bursty_s7.txt"
SHAPE = dict(vocab_size=64, d_model=64, d_ff=128, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, dtype="float32")


# ---------------------------------------------------------- generation
@pytest.mark.parametrize("name,kw", [
    ("poisson", dict(seed=3, n_requests=8)),
    ("bursty", dict(seed=3, n_requests=8)),
    ("poisson", dict(seed=13, n_requests=24, vocab_size=64, rate_rps=40.0)),
    ("bursty", dict(seed=6, n_requests=12, vocab_size=151936, rate_rps=5.0,
                    burst_len=3, burst_factor=4.0)),
])
def test_trace_text_is_byte_equal_to_the_reference(name, kw):
    mk, ref_mk = {"poisson": (poisson_config, jax_trace.poisson_config),
                  "bursty": (bursty_config, jax_trace.bursty_config)}[name]
    text = trace_to_text(generate_trace(mk(**kw)))
    assert text == jax_trace.trace_to_text(jax_trace.generate_trace(ref_mk(**kw)))
    assert trace_to_text(trace_from_text(text)) == text


def test_golden_trace_regenerates_byte_for_byte():
    golden = GOLDEN.read_text()
    trace = trace_from_text(golden)
    assert trace_to_text(generate_trace(trace.config)) == golden
    assert trace.config.process == "bursty"
    assert len(trace.requests) == trace.config.n_requests == 12


@pytest.mark.parametrize("field,value,msg", [
    ("arrival_s", 0.0, "must be > 0"),
    ("arrival_s", -1.5, "must be > 0"),
    ("klass", "nosuch", "unknown class"),
    ("session_id", "t000", "duplicate session id 't000'"),
    ("priority", 7, "priority disagrees"),
])
def test_validate_rejects_what_the_reference_rejects(field, value, msg):
    for gen, validate in ((generate_trace, validate_trace),
                          (jax_trace.generate_trace, jax_trace.validate_trace)):
        trace = gen((poisson_config if gen is generate_trace
                     else jax_trace.poisson_config)(seed=0, n_requests=4))
        reqs = list(trace.requests)
        reqs[2] = dataclasses.replace(reqs[2], **{field: value})
        with pytest.raises(ValueError, match=msg):
            validate(dataclasses.replace(trace, requests=tuple(reqs)))


def test_bursty_means_match_offered_load():
    cfg = bursty_config(seed=9, n_requests=400, rate_rps=50.0)
    trace = generate_trace(cfg)
    rate = cfg.n_requests / trace.requests[-1].arrival_s
    assert 0.6 * cfg.rate_rps < rate < 1.6 * cfg.rate_rps


# -------------------------------------------------------------- replay
@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    cfg = get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(11))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             "cpu")
    return JaxModel(jcfg), jparams, Model(cfg, device="cpu"), params


def _replay(models, tcfg, *, chaos_seed=None, **kw):
    """Replay the trace of ``tcfg`` (built by each package) through both
    schedulers; equal events, streams, virtual stamps and SLO reports.
    Returns (port result, port report)."""
    jm, jparams, model, params = models
    mk = poisson_config if tcfg[0] == "poisson" else bursty_config
    ref_mk = getattr(jax_trace, f"{tcfg[0]}_config")
    trace, ref_trace = generate_trace(mk(**tcfg[1])), \
        jax_trace.generate_trace(ref_mk(**tcfg[1]))
    kw = dict(dict(n_slots=2, max_len=trace.max_len() + 1, paged=True,
                   page_size=8, timed=False), **kw)
    inj = ref_inj = None
    if chaos_seed is not None:
        text = plan_to_text(generate_fault_plan(
            FaultPlanConfig(seed=chaos_seed, n_faults=12, horizon_s=round(
                trace.requests[-1].arrival_s + 0.25, 6)),
            session_ids=[r.session_id for r in trace.requests]))
        inj = FaultInjector(plan_from_text(text))
        ref_inj = jax_faults.FaultInjector(jax_faults.plan_from_text(text))
        kw["self_audit"] = True
    ref_s = JaxScheduler(jm, jparams, shared_programs=True,
                         fault_injector=ref_inj, **kw)
    sched = SlotScheduler(model, params, fault_injector=inj, **kw)
    for a, b in zip(ref_trace.requests, trace.requests):
        ref_s.submit(a)
        sched.submit(b)
    ref, got = ref_s.run(), sched.run()
    assert got.events == ref.events
    assert (got.arrivals, got.now_s, got.horizon_hist, got.preemptions) == \
        (ref.arrivals, ref.now_s, ref.horizon_hist, ref.preemptions)
    for sid, a in ref.sessions.items():
        b = got.sessions[sid]
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=sid)
        np.testing.assert_array_equal(b.token_times_s, a.token_times_s)
        assert (b.arrival_s, b.ttft_s, b.status, b.klass, b.priority) == \
            (a.arrival_s, a.ttft_s, a.status, a.klass, a.priority)
    rep = slo_report(got, trace.classes)
    assert rep == jax_trace.slo_report(ref, ref_trace.classes)
    json.dumps(rep, allow_nan=False)
    return got, rep


POISSON = ("poisson", dict(seed=4, n_requests=6, vocab_size=64, rate_rps=40.0))
BURSTY = ("bursty", dict(seed=6, n_requests=6, vocab_size=64, rate_rps=40.0,
                         burst_len=3))


@pytest.mark.parametrize("tcfg,arm", [
    (POISSON, dict(steps_per_tick=1)),
    (BURSTY, dict(steps_per_tick=8)),
    (BURSTY, dict(steps_per_tick=8, adaptive_k=True)),
    (BURSTY, dict(steps_per_tick=8, adaptive_k=True,
                  priority_preemption=False)),
    (BURSTY, dict(n_pages=9, priority_preemption=False)),
], ids=["poisson_k1", "bursty_k8", "bursty_adaptive",
        "bursty_adaptive_fifo", "bursty_tight_fifo"])
def test_replay_matches_the_reference(models, tcfg, arm):
    res, rep = _replay(models, tcfg, **arm)
    assert res.preemptions > 0 or "n_pages" not in arm
    assert res.arrivals == tcfg[1]["n_requests"]
    for s in res.sessions.values():
        assert np.all(np.diff(s.token_times_s) > 0)
        assert s.token_times_s[0] >= s.arrival_s and s.ttft_wall_s is None
    assert rep["sessions"] == tcfg[1]["n_requests"]


@pytest.mark.parametrize("policy,chaos_seed", [("spill", 7), ("lookahead", 3),
                                               ("prefer-device", 7)])
def test_replay_with_tier_and_fault_plan_matches_the_reference(models, policy,
                                                               chaos_seed):
    """What ``serve --kv-tier host --trace poisson --fault-plan mixed``
    runs: a tight pool, the host tier and a seeded mixed plan."""
    tcfg = ("poisson", dict(seed=13, n_requests=8, vocab_size=64,
                            rate_rps=60.0))
    res, rep = _replay(models, tcfg, chaos_seed=chaos_seed, n_pages=10,
                       kv_tier="host", tier_policy=policy, prefix_cache=True)
    assert res.faults_injected > 0 and res.preemptions > 0
    assert (res.pages_spilled > 0) == (policy != "prefer-device")
    assert rep["sessions"] == 8


def test_priority_preemption_protects_high_priority(models):
    """Under page pressure the FIFO order evicts the youngest session
    even when it is the high-priority one; priority order evicts the
    low-priority one.  Streams stay identical either way."""
    _, _, model, params = models
    reqs = [SessionRequest("low", np.arange(4) % 64, 16, priority=0),
            SessionRequest("high", np.arange(5) % 64, 16, priority=1)]
    victims, streams = {}, {}
    for prio in (False, True):
        sched = SlotScheduler(model, params, n_slots=2, max_len=24, paged=True,
                              page_size=4, n_pages=7, timed=False,
                              priority_preemption=prio)
        for r in reqs:
            sched.submit(r)
        res = sched.run()
        victims[prio] = {e[1] for e in res.events if e[0] == "preempt"}
        streams[prio] = {r.session_id: res.tokens_for(r.session_id).tolist()
                         for r in reqs}
    assert victims == {False: {"high"}, True: {"low"}}
    assert streams[False] == streams[True]


def test_counters_are_per_run_clock_is_cumulative(models):
    """Two traced waves through one scheduler: ``arrivals`` and
    ``horizon_hist`` reset per run, the virtual clock does not, and the
    second wave's arrivals are rebased onto it."""
    _, _, model, params = models
    sched = SlotScheduler(model, params, n_slots=2, max_len=48, paged=True,
                          page_size=8, timed=False, steps_per_tick=4,
                          adaptive_k=True)
    t1 = generate_trace(poisson_config(seed=8, n_requests=4, vocab_size=64,
                                       rate_rps=40.0))
    for r in t1.requests:
        sched.submit(r)
    res1 = sched.run()
    t2 = generate_trace(poisson_config(seed=9, n_requests=3, vocab_size=64,
                                       rate_rps=40.0))
    for r in t2.requests:
        sched.submit(dataclasses.replace(r, session_id="w2_" + r.session_id))
    res2 = sched.run()
    assert res1.arrivals == 4 and res2.arrivals == 3
    assert res2.now_s > res1.now_s > 0
    assert 0 < sum(res2.horizon_hist.values()) < res2.ticks + 1
    for r in t2.requests:
        assert res2.sessions["w2_" + r.session_id].arrival_s == \
            pytest.approx(res1.now_s + r.arrival_s)


def test_serve_cli_trace_tier_faults(capsys):
    """The launcher's trace replay with the host tier and a mixed fault
    plan prints the tier, chaos, recovery and SLO lines."""
    from repro_torch.launch import serve
    res, rep = serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                           "cpu", "--paged", "--slots", "2", "--sessions", "6",
                           "--pages", "12", "--kv-tier", "host", "--trace",
                           "poisson", "--fault-plan", "mixed"])
    out = capsys.readouterr().out
    assert "replayed poisson trace (seed 13, 6 requests at 25 req/s)" in out
    assert "kv tier (spill): " in out
    assert "chaos plan (mixed, seed 7): " in out and "recovery: " in out
    assert "goodput under SLO: " in out and "ttft p50/p95/p99" in out
    assert rep["sessions"] == 6 and len(res.sessions) == 6
    serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                "--slots", "2", "--sessions", "4", "--trace", "bursty",
                "--slo-json"])
    assert json.loads(capsys.readouterr().out)["sessions"] == 4
