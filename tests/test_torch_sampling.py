"""The port's sampling against the JAX package's, on the CPU, and the
stochastic streams of the engine's loops and the horizon-K scheduler.

Greedy ``sample`` must equal the reference's token for token.  A
temperature draw is the reference's ``jax.random.categorical`` (the
argmax of the scaled, top-k-masked logits plus Gumbel noise), so the two
packages draw from one distribution, each from its own generator: over
20000 seeded draws each package's frequencies must pass a chi-square
test against the exact softmax at p >= 1e-3, and no draw may fall
outside the top k.  The streams themselves differ by design (a torch
``Generator`` against the reference's folded keys); the port's own must
be deterministic in the seed, equal between its fused and streamed
loops, and complete every session of a horizon-K scheduler.

About 15 s on one worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.serving.sampling import sample as jax_sample
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine, SessionRequest, SlotScheduler
from repro_torch.serving.sampling import gumbel_argmax, sample

V, DRAWS, TEMPERATURE = 16, 20000, 0.8
P_MIN = 1e-3


def _logits(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3


@pytest.mark.parametrize("shape", [(5, 97), (3, 4, 97), (1, 2048)])
def test_greedy_sample_equals_reference(shape):
    logits = _logits(*shape, seed=len(shape))
    got = sample(torch.from_numpy(logits))
    want = np.asarray(jax_sample(jnp.asarray(logits), None))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape[:-1]
    np.testing.assert_array_equal(got.numpy(), want)


def _exact(logits: np.ndarray, top_k: int) -> np.ndarray:
    lf = logits.astype(np.float64) / TEMPERATURE
    if top_k:
        lf = np.where(lf < np.sort(lf)[-top_k], -np.inf, lf)
    p = np.exp(lf - lf.max())
    return p / p.sum()


def _draws(package: str, logits: np.ndarray, top_k: int) -> np.ndarray:
    """DRAWS tokens from one batched call over the repeated row."""
    rows = np.broadcast_to(logits, (DRAWS, V)).copy()
    if package == "port":
        gen = torch.Generator().manual_seed(1234 + top_k)
        return sample(torch.from_numpy(rows), gen, temperature=TEMPERATURE,
                      top_k=top_k).numpy()
    return np.asarray(jax_sample(jnp.asarray(rows), jax.random.PRNGKey(1234 + top_k),
                                 temperature=TEMPERATURE, top_k=top_k))


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("top_k", [0, 5])
def test_temperature_draws_follow_the_softmax(package, top_k):
    logits = np.linspace(-2.0, 2.5, V, dtype=np.float32)[
        np.random.default_rng(3).permutation(V)]
    p = _exact(logits, top_k)
    toks = _draws(package, logits, top_k)
    assert toks.shape == (DRAWS,) and toks.min() >= 0 and toks.max() < V
    counts = np.bincount(toks, minlength=V)
    support = p > 0
    assert counts[~support].sum() == 0          # nothing outside the top k
    assert support.sum() == (top_k or V)
    res = stats.chisquare(counts[support], DRAWS * p[support])
    assert res.pvalue >= P_MIN, (package, top_k, res)


def test_port_and_reference_frequencies_agree():
    """The two packages' top-5 frequencies against each other (a
    two-sample chi-square), beside each against the softmax above."""
    logits = np.linspace(-2.0, 2.5, V, dtype=np.float32)
    a = np.bincount(_draws("port", logits, 5), minlength=V)
    b = np.bincount(_draws("reference", logits, 5), minlength=V)
    keep = (a + b) > 0
    assert keep.sum() == 5
    res = stats.chi2_contingency(np.stack([a[keep], b[keep]]))
    assert res.pvalue >= P_MIN, res


def test_gumbel_argmax_clamps_zero_variates():
    """E = 0 gives +inf noise; clamped, a masked (-inf) logit stays -inf
    and never wins, and no NaN reaches the argmax."""
    lf = torch.tensor([[float("-inf"), 0.5, -1.0, float("-inf"), 2.0],
                       [float("-inf"), float("-inf"), -3.0, float("-inf"), -4.0]])
    for e in (torch.zeros_like(lf),
              torch.where(torch.isinf(lf), 0.0, 1.0),
              torch.tensor([[0.0, 1e-30, 1.0, 0.0, 50.0],
                            [0.0, 0.0, 2.0, 0.0, 1e-38]])):
        got = gumbel_argmax(lf, e)
        assert got.dtype == torch.int32
        assert all(torch.isfinite(lf[i, int(t)]) for i, t in enumerate(got)), e
    assert gumbel_argmax(lf, torch.zeros_like(lf)).tolist() == [4, 2]


@pytest.mark.parametrize("top_k", [0, 3])
def test_sample_with_zero_variates_draws_no_masked_token(monkeypatch, top_k):
    """``sample`` end to end with every Exp(1) variate 0 (the extreme the
    clamp guards): the top-k mask holds and the draw is the argmax."""
    monkeypatch.setattr(torch.Tensor, "exponential_",
                        lambda self, *a, **k: self.zero_())
    logits = torch.from_numpy(_logits(6, 40, seed=9))
    got = sample(logits, torch.Generator(), temperature=TEMPERATURE, top_k=top_k)
    assert torch.equal(got, logits.argmax(-1).to(torch.int32))


def test_sample_is_deterministic_in_the_generator():
    logits = torch.from_numpy(_logits(4, 3, 64, seed=5))     # (B, K, V) codebooks
    a, b, c = (sample(logits, torch.Generator().manual_seed(s),
                      temperature=TEMPERATURE, top_k=8) for s in (1, 1, 2))
    assert a.shape == (4, 3) and torch.equal(a, b) and not torch.equal(a, c)
    top = torch.topk(logits, 8).indices
    assert bool((top == a[..., None]).any(-1).all())


# ------------------------------------------------------------- engine loops
def _engine(name):
    cfg = get_config(name).reduced().replace(dtype="float32")
    model = Model(cfg, device="cpu")
    return DecodeEngine(model, model.init(torch.Generator().manual_seed(0)))


def _prompt(cfg, n=12):
    shape = (1, n, cfg.n_codebooks) if cfg.n_codebooks else (1, n)
    g = torch.Generator().manual_seed(4)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                    dtype=torch.int32)}


@pytest.mark.parametrize("name", ["qwen2.5-3b", "musicgen-large", "mamba2-2.7b"])
def test_fused_and_streamed_draw_the_same_stochastic_tokens(name):
    """Both loops draw in one order (the first token from the prefill's
    logits, then one (B, V) draw a step), so one seed gives one stream;
    another seed another."""
    eng = _engine(name)
    batch = _prompt(eng.cfg)
    kw = dict(max_len=32, n_new=10, temperature=TEMPERATURE, top_k=20)
    fused = eng.generate_fused(batch, seed=7, **kw).tokens
    streamed = eng.generate_streamed(batch, seed=7, **kw).tokens
    want = (1, 10, eng.cfg.n_codebooks) if eng.cfg.n_codebooks else (1, 10)
    assert tuple(fused.shape) == want and torch.equal(fused, streamed)
    assert torch.equal(eng.generate_fused(batch, seed=7, **kw).tokens, fused)
    assert not torch.equal(eng.generate_fused(batch, seed=8, **kw).tokens, fused)
    greedy = eng.generate_fused(batch, max_len=32, n_new=10).tokens
    assert not torch.equal(greedy, fused)


def test_fused_executors_are_keyed_by_temperature_and_top_k():
    """A graph holds its temperature and top-k: each setting has its own
    executor (and, stochastic, its own generator); repeating one adds
    none."""
    eng = _engine("qwen2.5-3b")
    batch = _prompt(eng.cfg)
    settings = [(0.0, 0), (TEMPERATURE, 0), (TEMPERATURE, 5), (0.5, 5)]
    for _ in range(2):
        for t, k in settings:
            eng.generate_fused(batch, max_len=32, n_new=6, temperature=t, top_k=k)
    fused = [key for key in eng._executors if "steps" in key]
    assert len(fused) == len(settings) and len(eng._caches) == 1
    assert {key[-2:] for key in fused} == set(settings)
    assert {key for key in eng._generators if "steps" in key} == {
        key for key in fused if key[-2] > 0}


# ------------------------------------------------------ horizon-K scheduler
def _requests(cfg, n=5):
    rng = np.random.default_rng(0)
    return [SessionRequest(f"s{i}", rng.integers(0, cfg.vocab_size, 6 + 3 * i)
                           .astype(np.int32), 5 + i % 3) for i in range(n)]


def _serve(eng, reqs, seed, **kw):
    sched = SlotScheduler(eng.model, eng.params, n_slots=2, max_len=40,
                          paged=True, page_size=8, temperature=TEMPERATURE,
                          top_k=5, seed=seed, **kw)
    for r in reqs:
        sched.submit(r)
    return sched.run()


@pytest.mark.parametrize("kw", [dict(steps_per_tick=4),
                                dict(steps_per_tick=4, n_pages=1 + 5),
                                dict(steps_per_tick=4, adaptive_k=True)],
                         ids=["k4", "k4-oversubscribed", "adaptive"])
def test_stochastic_horizon_scheduler_is_seeded_and_completes(kw):
    eng = _engine("qwen2.5-3b")
    reqs = _requests(eng.cfg)
    a, b, c = (_serve(eng, reqs, s, **kw) for s in (3, 3, 4))
    assert a.events == b.events and a.events != c.events
    for res in (a, c):
        assert {sid: len(s.tokens) for sid, s in res.sessions.items()} == \
            {r.session_id: r.max_new_tokens for r in reqs}
        assert all(0 <= t < eng.cfg.vocab_size
                   for s in res.sessions.values() for t in s.tokens)
    assert sum(a.horizon_hist.values()) == a.decode_steps
    if "n_pages" in kw:
        assert a.preemptions >= 1
