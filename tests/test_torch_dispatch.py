"""The port's dispatch A/B against the JAX package's, on the CPU, on
reduced qwen2.5-3b in f32 with the same (bridged) weights and inputs made
from a seed with numpy: ``Model.step_program`` and the three executors of
``core/dispatch.py``, the measurement protocol and statistics, the
scheduler's eager and stage_jit arms, the engine's per-shape cache and
``serve --dispatch``.

Tolerances: f32 logits agree with the JAX package's to 1e-5 x max|logit|
(the two frameworks sum matmuls in different orders); K/V rows to 1e-5
relative, int8 codes to one step.  Within the port every executor runs
``decode_step``'s own ops on the CPU, so its logits and cache must be
bit-equal to plain ``decode_step`` calls.  Positions and scheduler event
logs must be identical."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import stats as jax_stats
from repro.core.dispatch import MODES as JAX_MODES
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SessionRequest as JaxRequest
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import dispatch, protocol, stats
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine, SessionRequest

NAME = "qwen2.5-3b"
CPU = "cpu"
MAX_LEN = 32
ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

# kind: (batch, prompt lengths per row, decode steps, sliding window, int8 KV)
KINDS = {
    "contiguous": (2, (9,), 3, None, False),
    "slotted": (2, (5, 9), 3, None, False),
    "int8_kv": (1, (6,), 3, None, True),
    "ring_past_wrap": (1, (6,), 6, 8, False),   # kv_len 8: pos 6..11 wraps
}


def test_modes_match_the_reference():
    assert dispatch.MODES == JAX_MODES


@functools.lru_cache(maxsize=None)
def _weights(window=None):
    jcfg = jax_get_config(NAME).reduced().replace(dtype="float32")
    cfg = get_config(NAME).reduced().replace(dtype="float32")
    if window:
        jcfg, cfg = (c.replace(sliding_window=window) for c in (jcfg, cfg))
    params = JaxModel(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, from_jax_params(np_params, cfg, CPU)


def _inputs(kind):
    B, lengths, steps, _, _ = KINDS[kind]
    rng = np.random.default_rng(sum(map(ord, kind)))
    vocab = _weights()[0].vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]
    feed = rng.integers(0, vocab, (steps, B, 1)).astype(np.int32)
    return prompts, feed


def _jax_cache(kind):
    """The JAX model and its prefilled cache (immutable: every arm starts
    from it)."""
    B, _, _, window, int8 = KINDS[kind]
    jcfg, _, params, _ = _weights(window)
    m = JaxModel(jcfg)
    prompts, _ = _inputs(kind)
    if kind == "slotted":
        cache = m.init_cache(B, MAX_LEN, slotted=True)
        prefill = jax.jit(m.prefill_into_slot)
        for slot, p in enumerate(prompts):
            _, cache = prefill(params, {"tokens": jnp.asarray(p)[None]}, cache,
                               jnp.int32(slot))
        return m, cache
    kw = dict(kv_dtype=jnp.int8) if int8 else {}
    batch = {"tokens": jnp.asarray(np.stack(prompts * B))}
    _, cache = jax.jit(m.prefill)(params, batch, m.init_cache(B, MAX_LEN, **kw))
    return m, cache


def _port_cache(kind):
    B, _, _, window, int8 = KINDS[kind]
    _, cfg, _, params = _weights(window)
    m = Model(cfg, decode_backend="cuda", device=CPU)
    prompts, _ = _inputs(kind)
    kw = dict(kv_dtype=torch.int8) if int8 else {}
    if kind == "slotted":
        cache = m.init_cache(B, MAX_LEN, slotted=True)
        for slot, p in enumerate(prompts):
            m.prefill_into_slot(params, {"tokens": torch.from_numpy(p)[None]},
                                cache, slot)
        return m, cache
    batch = {"tokens": torch.from_numpy(np.stack(prompts * B))}
    return m, m.prefill(params, batch, m.init_cache(B, MAX_LEN, **kw))[1]


def _np_cache(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def _jax_runs(kind):
    """Logits and final cache of the JAX decode_step and of each JAX
    executor, fed the same tokens."""
    _, _, _, window, _ = KINDS[kind]
    params = _weights(window)[2]
    _, feed = _inputs(kind)
    m, cache0 = _jax_cache(kind)
    step = jax.jit(m.decode_step)
    cache, logits = cache0, []
    for tok in feed:
        lg, cache = step(params, cache, jnp.asarray(tok))
        logits.append(np.asarray(lg))
    out = {"decode_step": (logits, _np_cache(cache))}
    program = m.step_program(params, cache0)
    for mode in JAX_MODES:
        run = program.executor(mode)
        state = {"tokens": None, "cache": cache0}
        logits = []
        for tok in feed:
            state = run(dict(state, tokens=jnp.asarray(tok)))
            logits.append(np.asarray(state["logits"]))
        out[mode] = (logits, _np_cache(state["cache"]))
    return out


def _close_logits(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=what)


def _close_cache(got, want, what):
    assert set(got) == set(want), what
    np.testing.assert_array_equal(got["pos"], want["pos"], err_msg=what)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in want:
            continue
        g, w = got[key], want[key]
        if w.dtype == np.int8:      # codes: one step at most (rounding ties)
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, what
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(
                1.0, float(np.abs(w).max())), err_msg=f"{what}: {key}")


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_executor_matches_jax_and_decode_step(kind, mode):
    _, _, _, window, _ = KINDS[kind]
    params = _weights(window)[3]
    _, feed = _inputs(kind)
    ref = _jax_runs(kind)

    model, plain_cache = _port_cache(kind)
    plain = [model.decode_step(params, plain_cache, torch.from_numpy(t))[0].clone()
             for t in feed]

    _, cache = _port_cache(kind)
    run = model.step_program(params, cache).executor(mode)
    state = {"tokens": None, "cache": cache}
    for i, tok in enumerate(feed):
        state = run(dict(state, tokens=torch.from_numpy(tok)))
        assert state["cache"] is cache
        assert torch.equal(state["logits"], plain[i]), f"{mode} step {i}"
        got = state["logits"].numpy()
        for arm in (mode, "decode_step"):
            _close_logits(got, ref[arm][0][i], f"{kind}/{mode} vs jax {arm}, step {i}")
    for key in cache:
        assert torch.equal(cache[key], plain_cache[key]), key
    for arm in (mode, "decode_step"):
        _close_cache(_np_cache(cache), ref[arm][1], f"{kind}/{mode} vs jax {arm}")


def test_stages_and_launch_counts():
    _, cfg, _, params = _weights()
    model = Model(cfg, device=CPU)
    program = DecodeEngine(model, params).step_program(model.init_cache(1, 16))
    assert len(program.stages) == cfg.n_layers + 2
    want = {"eager": -1, "stage_jit": cfg.n_layers + 2, "full_jit": 1}
    for mode, n in want.items():
        assert dispatch.launch_count(program, mode) == n
        assert program.launch_count(mode) == n
    with pytest.raises(ValueError, match="mode must be one of"):
        program.executor("not_a_mode")
    with pytest.raises(ValueError, match="mode must be one of"):
        program.launch_count("not_a_mode")


def test_step_program_refuses_paged_and_ssm():
    _, cfg, _, params = _weights()
    model = Model(cfg, device=CPU)
    paged = model.init_cache(2, 16, paged=True, page_size=4)
    with pytest.raises(NotImplementedError, match="full_jit arm only"):
        model.step_program(params, paged)
    for name in ("mamba2-2.7b", "zamba2-1.2b"):
        ssm = Model(get_config(name).reduced(), device=CPU)
        with pytest.raises(NotImplementedError, match="attention families"):
            ssm.step_program(None, None)


# ---------------------------------------------------------------- stats, protocol
PAPER_EAGER = [14.749, 14.721, 14.776, 14.896, 14.800,
               14.869, 14.847, 15.147, 14.667, 14.812]
PAPER_GRAPHED = [11.850, 11.764, 11.770, 11.784, 11.766,
                 11.760, 11.775, 11.763, 11.755, 11.775]
STATS_CASES = [[1, 2, 3, 4, 100], [10.0, 10.0, 10.0], [7.25], [],
               [1.0, 2.0, 3.0, 4.0], PAPER_EAGER, PAPER_GRAPHED]


@pytest.mark.parametrize("xs", STATS_CASES, ids=range(len(STATS_CASES)))
def test_stats_equal_the_reference(xs):
    if xs:
        for fn in ("p50", "mean", "std", "cv"):
            assert getattr(stats, fn)(xs) == getattr(jax_stats, fn)(xs), fn
    for seed in (0, 3):
        got = stats.bootstrap_ci_mean(xs, seed=seed)
        want = jax_stats.bootstrap_ci_mean(xs, seed=seed)
        np.testing.assert_array_equal(got, want)


def test_paper_table2_statistics():
    """The paper's N=10 sessions reproduce its row: mean 1.259, CI
    [1.253, 1.267]."""
    sp = stats.paired_speedups(PAPER_EAGER, PAPER_GRAPHED)
    np.testing.assert_array_equal(
        sp, jax_stats.paired_speedups(PAPER_EAGER, PAPER_GRAPHED))
    assert stats.mean(sp) == pytest.approx(1.259, abs=0.001)
    assert stats.p50([1, 2, 3, 4, 100]) == 3 and stats.cv([10.0] * 3) == 0.0
    lo, hi = stats.bootstrap_ci_mean(sp, seed=0)
    assert lo == pytest.approx(1.253, abs=0.003)
    assert hi == pytest.approx(1.267, abs=0.003)
    assert np.isnan(stats.bootstrap_ci_mean([])[0])


def test_measure_cell_window():
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        return {"logits": torch.zeros(())}
    res = protocol.measure_cell(step, warmup=2, steps=5, name="t")
    assert calls["n"] == 7
    assert len(res.step_times_s) == 5 and res.p50_ms >= 0
    assert res.to_json()["warmup"] == 2
    assert (protocol.WARMUP_STEPS, protocol.MEASURED_STEPS) == (5, 30)


def test_run_ab_paired():
    def mk_slow(s):
        return lambda: torch.ones(400_000).sum()

    def mk_fast(s):
        return lambda: torch.ones(16).sum()
    made = []
    ab = protocol.run_ab(lambda s: made.append(s) or mk_slow(s), mk_fast,
                         n_sessions=3, warmup=1, steps=5)
    summary = ab.summary()
    assert made == [0, 1, 2]
    assert summary["n_sessions"] == 3 and len(summary["per_session"]) == 3
    assert summary["speedup_ci95"][0] <= summary["mean_speedup"] \
        <= summary["speedup_ci95"][1]
    assert summary["mean_speedup"] > 1


# ---------------------------------------------------------------- scheduler
@functools.lru_cache(maxsize=None)
def _engines():
    jcfg, cfg, jparams, params = _weights()
    return (JaxEngine(JaxModel(jcfg, decode_backend="pallas"), jparams),
            DecodeEngine(Model(cfg, decode_backend="cuda", device=CPU), params))


def _requests(n):
    rng = np.random.default_rng(5)
    vocab = _weights()[0].vocab_size
    return [(f"s{i}", rng.integers(0, vocab, (5, 9)[i % 2]).astype(np.int32),
             3 + i % 4) for i in range(n)]


@pytest.mark.parametrize("mode", ["eager", "stage_jit"])
def test_scheduler_arm_matches_jax(mode):
    """The contiguous slotted scheduler under a non-full_jit arm: event
    log and greedy streams equal the JAX SlotScheduler's under the same
    arm, and equal the port's own full_jit run."""
    jeng, peng = _engines()
    reqs = _requests(5)
    kw = dict(n_slots=2, max_len=24)
    ref = jeng.generate_continuous([JaxRequest(*r) for r in reqs],
                                   dispatch_mode=mode, **kw)
    got = peng.generate_continuous([SessionRequest(*r) for r in reqs],
                                   dispatch_mode=mode, **kw)
    full = peng.generate_continuous([SessionRequest(*r) for r in reqs], **kw)
    assert got.events == ref.events == full.events
    for sid, _, _ in reqs:
        np.testing.assert_array_equal(got.tokens_for(sid), ref.tokens_for(sid))
    assert got.decode_steps == ref.decode_steps
    assert got.launches_per_step == ref.launches_per_step
    assert got.launches_per_step == (-1 if mode == "eager"
                                     else peng.cfg.n_layers + 2)
    assert full.launches_per_step == 1


def test_scheduler_refuses_what_the_reference_refuses():
    from repro_torch.serving import SlotScheduler
    _, peng = _engines()
    model, params = peng.model, peng.params
    with pytest.raises(NotImplementedError, match="full_jit arm only"):
        SlotScheduler(model, params, n_slots=2, max_len=16, paged=True,
                      dispatch_mode="eager")
    with pytest.raises(NotImplementedError, match="full_jit"):
        SlotScheduler(model, params, n_slots=2, max_len=16,
                      dispatch_mode="stage_jit", steps_per_tick=4)
    with pytest.raises(ValueError, match="dispatch_mode"):
        SlotScheduler(model, params, n_slots=2, max_len=16,
                      dispatch_mode="graph")


# ---------------------------------------------------------------- engine, CLI
def test_engine_reuses_its_cache_per_shape():
    """Two requests through one engine (the second prefilled into the
    first's cache, in place) give the tokens of two fresh engines."""
    _, cfg, _, params = _weights()
    prompts, _ = _inputs("contiguous")
    batches = [{"tokens": torch.from_numpy(np.stack([p, p[::-1]]))}
               for p in (prompts[0], prompts[0][:5])]

    def fresh():
        return DecodeEngine(Model(cfg, device=CPU), params)
    eng = fresh()
    for gen in ("generate_streamed", "generate_fused"):
        for batch in batches:
            got = getattr(eng, gen)(batch, max_len=MAX_LEN, n_new=5).tokens
            want = getattr(fresh(), gen)(batch, max_len=MAX_LEN, n_new=5).tokens
            assert torch.equal(got, want), gen
    assert len(eng._caches) == 1


def test_engine_keys_each_loop_apart():
    """At n_new=2 the fused loop's horizon is one step, as the streamed
    loop's is: each loop keeps an executor of its own at the shared
    cache's shape, and each gives the tokens of a fresh engine."""
    _, cfg, _, params = _weights()
    prompts, _ = _inputs("contiguous")
    batch = {"tokens": torch.from_numpy(prompts[0][None])}
    eng = DecodeEngine(Model(cfg, device=CPU), params)
    for _ in range(2):
        for gen in ("generate_streamed", "generate_fused"):
            got = getattr(eng, gen)(batch, max_len=MAX_LEN, n_new=2).tokens
            want = getattr(DecodeEngine(Model(cfg, device=CPU), params), gen)(
                batch, max_len=MAX_LEN, n_new=2).tokens
            assert got.shape == (1, 2) and torch.equal(got, want), gen
    key = (1, MAX_LEN, None)    # the fused key adds (temperature, top_k)
    assert sorted(eng._executors, key=str) == [key + ("step",),
                                               key + ("steps", 1, 0.0, 0)]
    assert len(eng._caches) == 1


def test_serve_cli_dispatch_arms():
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME,
            "--reduced", "--device", "cpu", "--prompt-len", "6",
            "--new-tokens", "4", "--slots", "2", "--sessions", "3"]
    out = subprocess.run(base + ["--continuous", "--dispatch", "stage_jit"],
                         env=ENV, check=True, timeout=120, capture_output=True,
                         text=True).stdout
    assert "served 3 sessions through 2 slots (stage_jit" in out
    assert "run by the stage_jit executor" in out
    bad = subprocess.run(base + ["--paged", "--dispatch", "eager"], env=ENV,
                         timeout=120, capture_output=True, text=True)
    assert bad.returncode == 2 and "full_jit arm only" in bad.stderr
