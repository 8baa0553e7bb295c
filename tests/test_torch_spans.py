"""The port's span recorder (``repro_torch.core.spans``) on the CPU: the
recorder itself, the engine's and the scheduler's spans, and that turning
it on changes no token.  On the CPU spans have no device interval; the
device side is held on the card in ``test_torch_cuda_kernels.py``."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import spans
from repro_torch.kernels import _build
from repro_torch.launch.serve import mixed_requests
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine, SlotScheduler

ENGINE_NAMES = ("engine.prefill", "engine.first_token", "engine.replay",
                "engine.sample", "engine.readback")
TICK_ORDER = ("sched.admit", "sched.dispatch", "sched.readback",
              "sched.reconcile")


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2.5-3b").reduced()
    m = Model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _batch(model, seed=1, n=12):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, model[0].cfg.vocab_size, (1, n),
                                    generator=g)}


def _stream(engine, batch, timed=True, n_new=6):
    return engine.generate_streamed(batch, max_len=32, n_new=n_new, timed=timed)


def _serve(model, K, paged=True, n=6):
    m, params = model
    kw = dict(paged=True, page_size=4, prefill_chunk=8) if paged else {}
    sched = SlotScheduler(m, params, n_slots=3, max_len=48, steps_per_tick=K,
                          **kw)
    for r in mixed_requests(m.cfg, n, base_prompt=10, base_new=5, seed=3):
        sched.submit(r)
    return sched, sched.run()


def _by_id(export):
    return {s["id"]: s for s in export["spans"]}


def test_spans_nest_with_their_parents():
    with spans.recording("cpu") as rec:
        a = rec.open("a", request=7)
        b = rec.open("b", a, 7)
        rec.close(b, counts={"n": 3})
        c = rec.open("c", a, 7)
        rec.close(c)
        rec.close(a)
    got = _by_id(rec.export())
    assert [got[i]["parent"] for i in (a, b, c)] == [-1, a, a]
    assert got[b]["counts"] == {"n": 3} and got[c]["counts"] == {}
    for child in (b, c):
        assert got[a]["t0_ns"] <= got[child]["t0_ns"] <= got[child]["t1_ns"] \
            <= got[a]["t1_ns"]
    assert got[b]["t1_ns"] <= got[c]["t0_ns"]
    assert all(s["device"] is None and s["request"] == 7 for s in got.values())


def test_stamps_given_by_the_caller_are_kept():
    with spans.recording("cpu") as rec:
        s = rec.open("x", t=100)
        rec.close(s, t=250)
    span, = rec.export()["spans"]
    assert (span["t0_ns"], span["t1_ns"]) == (100, 250)


def test_engine_request_spans_share_one_request_id(model):
    engine = DecodeEngine(*model)
    with spans.recording("cpu") as rec:
        _stream(engine, _batch(model))
        _stream(engine, _batch(model, seed=2))
    ex = rec.export()
    tops = [s for s in ex["spans"] if s["name"] == "engine.request"]
    assert len(tops) == 2 and tops[0]["request"] != tops[1]["request"]
    for top in tops:
        kids = [s for s in ex["spans"] if s["parent"] == top["id"]]
        assert {s["request"] for s in kids} == {top["request"]}
        assert [s["name"] for s in kids][:3] == ["engine.prefill",
                                                 "engine.first_token",
                                                 "engine.replay"]
        names = [s["name"] for s in kids]
        # 6 tokens: the first from the prefill, five replays after it
        assert [names.count(n) for n in ENGINE_NAMES] == [1, 1, 5, 5, 5]
        starts = [s["t0_ns"] for s in kids]
        assert starts == sorted(starts)
        assert all(top["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= top["t1_ns"]
                   for s in kids)


def test_untimed_engine_request_has_no_readback(model):
    engine = DecodeEngine(*model)
    with spans.recording("cpu") as rec:
        _stream(engine, _batch(model), timed=False)
    names = [s["name"] for s in rec.export()["spans"]]
    assert "engine.readback" not in names and names.count("engine.replay") == 5


@pytest.mark.parametrize("K", [1, 4])
def test_tick_children_lie_inside_it_in_order(model, K):
    with spans.recording("cpu") as rec:
        sched, res = _serve(model, K)
    ex = rec.export()
    got = _by_id(ex)
    ticks = [s for s in ex["spans"] if s["name"] == "sched.tick"]
    assert len(ticks) == sched.tick_count
    tokens = 0
    for tick in ticks:
        kids = sorted((s for s in ex["spans"] if s["parent"] == tick["id"]),
                      key=lambda s: s["t0_ns"])
        names = [s["name"] for s in kids]
        assert names in (["sched.admit"], list(TICK_ORDER)), names
        for a, b in zip(kids, kids[1:]):
            assert a["t1_ns"] <= b["t0_ns"]
        assert all(tick["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= tick["t1_ns"]
                   for s in kids)
        assert tick["counts"]["dispatches"] == (len(kids) == 4)
        tokens += tick["counts"]["tokens"]
    assert tokens == sum(ev[0] == "token" for ev in res.events)
    steps = [s["counts"]["steps"] for s in ex["spans"]
             if s["name"] == "sched.dispatch"]
    assert steps and set(steps) == {K}
    for s in ex["spans"]:
        if s["name"] == "sched.chunk":
            assert got[s["parent"]]["name"] == "sched.admit"


def test_chunk_spans_carry_their_session_and_tokens(model):
    with spans.recording("cpu") as rec:
        sched, res = _serve(model, 4)
    chunks = [s for s in rec.export()["spans"] if s["name"] == "sched.chunk"]
    assert chunks and {s["request"] for s in chunks} == set(res.sessions)
    assert sum(s["counts"]["tokens"] for s in chunks) == sched.prefill_tokens
    assert all(1 <= s["counts"]["tokens"] <= 8 for s in chunks)
    prompts = {r.session_id: len(r.prompt) for r in
               mixed_requests(model[0].cfg, 6, base_prompt=10, base_new=5,
                              seed=3)}
    for sid, n in prompts.items():
        assert sum(s["counts"]["tokens"] for s in chunks
                   if s["request"] == sid) == n


@pytest.mark.parametrize("K,paged", [(1, True), (4, True), (1, False)],
                         ids=["paged-K1", "paged-K4", "contiguous-K1"])
def test_dispatch_spans_sum_to_host_dispatch_s_exactly(model, K, paged):
    with spans.recording("cpu") as rec:
        sched, _ = _serve(model, K, paged=paged)
    total = 0.0
    for s in rec.export()["spans"]:
        if s["name"] == "sched.dispatch":
            total += (s["t1_ns"] - s["t0_ns"]) * 1e-9
    assert sched.host_dispatch_s > 0 and total == sched.host_dispatch_s
    sync = 0.0
    for s in rec.export()["spans"]:
        if s["name"] == "sched.readback":
            sync += (s["t1_ns"] - s["t0_ns"]) * 1e-9
    assert sync == sched.host_sync_s


def test_recorder_off_records_nothing(model):
    assert spans.recorder() is None
    engine = DecodeEngine(*model)
    with spans.recording("cpu") as rec:
        assert spans.recorder() is rec
    assert spans.recorder() is None
    _stream(engine, _batch(model))
    _serve(model, 4)
    spans.count("graph_captures")
    ex = rec.export()
    assert ex["spans"] == [] and ex["counters"]["graph_captures"] == 0


def test_a_second_recorder_is_refused():
    with spans.recording("cpu"):
        with pytest.raises(RuntimeError):
            with spans.recording("cpu"):
                pass
    assert spans.recorder() is None


def test_engine_tokens_equal_with_the_recorder_on_and_off(model):
    engine = DecodeEngine(*model)
    batch = _batch(model, seed=5)
    off = _stream(engine, batch, n_new=10)
    with spans.recording("cpu"):
        on = _stream(engine, batch, n_new=10)
        on_untimed = _stream(engine, batch, n_new=10, timed=False)
    assert torch.equal(off.tokens, on.tokens)
    assert torch.equal(off.tokens, on_untimed.tokens)


@pytest.mark.parametrize("K", [1, 4])
def test_scheduler_tokens_equal_with_the_recorder_on_and_off(model, K):
    _, off = _serve(model, K)
    with spans.recording("cpu"):
        _, on = _serve(model, K)
    assert on.events == off.events
    assert {k: np.asarray(s.tokens).tolist() for k, s in on.sessions.items()} \
        == {k: np.asarray(s.tokens).tolist() for k, s in off.sessions.items()}


def test_capacity_overflow_is_counted_not_raised(model):
    engine = DecodeEngine(*model)
    with spans.recording("cpu", capacity=5) as rec:
        out = _stream(engine, _batch(model))
    ex = rec.export()
    assert out.tokens.shape == (1, 6)
    # request, prefill, first token, the first replay and sample; then the
    # first readback and three spans of each of the four tokens after it
    assert [s["name"] for s in ex["spans"]] == [
        "engine.request", "engine.prefill", "engine.first_token",
        "engine.replay", "engine.sample"]
    assert rec.dropped == ex["dropped"] == 1 + 3 * 4


def test_counters_captures_and_builds(monkeypatch):
    monkeypatch.setattr(_build, "build_seconds", dict(_build.build_seconds))
    _build.build_seconds["rmsnorm"] = 0.0
    with spans.recording("cpu") as rec:
        spans.count("graph_captures")
        spans.count("graph_captures", 2)
        _build.build_seconds["rmsnorm"] = 4.5       # built while on
        _build.build_seconds["dequantize"] = 0.0    # found built
    counters = rec.export()["counters"]
    assert counters == {"graph_captures": 3, "kernel_builds": 1}


def test_profiler_ranges_carry_the_span_names(model):
    engine = DecodeEngine(*model)
    batch = _batch(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.recording("cpu"):
            _stream(engine, batch)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(ENGINE_NAMES) | {"engine.request"} <= names
    with spans.recording("cpu") as rec:     # no profiler: no ranges
        _stream(engine, batch)
    assert all(s[spans.RANGE] is None for s in rec._spans)


def test_chrome_trace_holds_every_span(model, tmp_path):
    with spans.recording("cpu") as rec:
        _serve(model, 4)
    path = tmp_path / "spans.json"
    rec.chrome_trace(str(path))
    data = json.loads(path.read_text())
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(rec.export()["spans"])
    assert {e["tid"] for e in xs} == {0}        # no device track on the CPU
    assert all(e["dur"] >= 0 and np.isfinite(e["ts"]) for e in xs)
    assert data["otherData"]["dropped"] == 0
