"""``shared_programs``: schedulers built back to back over one model share
one cache per cache signature (and, on the card, one set of captured
decode graphs), against the JAX package's shared schedulers, on the CPU.

Each case serves two waves of different requests, each through a new
scheduler over the same model with ``shared_programs=True`` on both
sides; every wave's event log, greedy streams, statuses and counters
must equal the reference's.  The port's later schedulers serve from the
first one's cache, zeroed in place, so a wave that reads a stale page,
scale or position of the wave before it shows here.  Then, port only: a
sampled follower draws what a fresh unshared scheduler with its seed
draws, the cache keeps its addresses across the sequence and is a new
one for another signature, a superseded scheduler raises before it
writes, and ``shared_programs=False`` allocates a cache per scheduler.

A small qwen2.5-3b-shaped config in f32 (vocab 64, d_model 64, 2
layers), the same bridged weights on both sides.  About 30 s on one
worker, most of it the JAX package's first compile of each case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving import SessionRequest as JaxRequest
from repro.serving import SlotScheduler as JaxScheduler
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import SessionRequest, SlotScheduler

SHAPE = dict(vocab_size=64, d_model=64, d_ff=128, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, dtype="float32")
COUNTERS = ("ticks", "decode_steps", "dispatches", "preemptions",
            "prefill_tokens", "prefix_hits", "prefix_tokens_saved",
            "cow_copies", "step_kv_blocks", "horizon_hist", "now_s",
            "kv_tier", "tier_policy", "pages_spilled", "pages_restored",
            "tier_restores", "host_prefix_hits", "host_pages_used")
PAGED = dict(n_slots=2, max_len=24, paged=True, page_size=4, timed=False)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, the port's model and params on the CPU),
    over the same weights: the JAX package's gather route (``sdpa``)
    against the port's default route, the kernels' plain versions on CPU
    tensors."""
    jcfg = jax_get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    cfg = get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(5))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             "cpu")
    return (JaxModel(jcfg, decode_backend="sdpa"), jparams, Model(cfg, device="cpu"),
            params)


def _wave(seed, n=4, preamble=0, prompt=5):
    """``n`` sessions of mixed prompt lengths (from ``prompt``) and
    budgets; ``preamble`` tokens shared by every prompt and an exact
    duplicate of the shared preamble (the copy-on-write admission) when
    given."""
    rng = np.random.RandomState(seed)
    common = rng.randint(0, 64, size=preamble).astype(np.int32)
    out = [(f"w{seed}s{i}", np.concatenate(
        [common, rng.randint(0, 64, size=prompt + 3 * (i % 3)).astype(np.int32)]),
        5 + 2 * (i % 2)) for i in range(n)]
    if preamble:
        out.append((f"w{seed}dup", common.copy(), 4))
    return out


def _port(models, reqs, *, shared=True, int8=False, **kw):
    _, _, model, params = models
    sched = SlotScheduler(model, params, shared_programs=shared,
                          kv_dtype=torch.int8 if int8 else None, **kw)
    for r in reqs:
        sched.submit(SessionRequest(*r))
    return sched, sched.run()


CASES = {
    "contiguous": dict(n_slots=2, max_len=24, timed=False),
    "paged_k1": dict(PAGED),
    "int8_k4_oversubscribed": dict(PAGED, n_pages=7, steps_per_tick=4,
                                   int8=True),
    "prefix_cow": dict(PAGED, prefix_cache=True, wave=dict(preamble=8)),
    "host_tier": dict(PAGED, n_pages=8, prefill_chunk=4, prefix_cache=True,
                      kv_tier="host", host_pages=24, wave=dict(n=5, prompt=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_back_to_back_schedulers_match_the_reference(models, case):
    """Two waves, each through a new shared scheduler on both sides:
    equal events, streams, statuses and counters wave by wave; the port's
    two schedulers serve from one cache; nothing is captured on the
    CPU."""
    jax_model, jparams, model, _ = models
    kw = dict(CASES[case])
    int8 = kw.pop("int8", False)
    wave = kw.pop("wave", {})
    caches, results = set(), []
    for seed in (1, 2):
        reqs = _wave(seed, **wave)
        ref_s = JaxScheduler(jax_model, jparams, shared_programs=True,
                             kv_dtype=jnp.int8 if int8 else None, **kw)
        for r in reqs:
            ref_s.submit(JaxRequest(*r))
        ref = ref_s.run()
        sched, got = _port(models, reqs, int8=int8, **kw)
        assert got.events == ref.events, f"wave {seed}"
        for sid in ref.sessions:
            a, b = ref.sessions[sid], got.sessions[sid]
            np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=sid)
            assert b.status == a.status, sid
        for field in COUNTERS:
            assert getattr(got, field) == getattr(ref, field), (seed, field)
        assert got.step_cache_size is None and sched.step_cache_size() is None
        caches.add(tuple(t.data_ptr() for t in sched.cache.values()))
        results.append(got)
        if sched.paged:
            sched.flush_prefix_cache()
            sched.store.flush_host()
            assert sched.store.allocator.n_free == sched.store.n_pages - 1
    assert len(caches) == 1, "a later scheduler allocated a cache of its own"
    if case == "int8_k4_oversubscribed":
        assert all(r.preemptions >= 1 for r in results)
    if case == "prefix_cow":
        assert all(r.cow_copies >= 1 and r.prefix_hits >= 1 for r in results)
    if case == "host_tier":
        assert all(r.preemptions >= 1 for r in results)
        assert all(r.tier_restores >= 1 for r in results)


@pytest.mark.parametrize("K", [1, 4])
def test_sampled_follower_draws_what_a_fresh_scheduler_draws(models, K):
    """Temperature 0.8, top_k 5: a shared scheduler that follows another
    (other requests, another seed) on the same entry gives the events and
    generator state of a fresh unshared scheduler with its seed; another
    seed draws other events."""
    kw = dict(PAGED, n_pages=7, steps_per_tick=K, temperature=0.8, top_k=5)
    reqs = _wave(4)
    _port(models, _wave(5), seed=3, **kw)
    runs = {}
    for label, shared, seed in (("follower", True, 11), ("fresh", False, 11),
                                ("other seed", True, 12)):
        sched, res = _port(models, reqs, shared=shared, seed=seed, **kw)
        runs[label] = (res.events, sched.gen.get_state())
    (ev, st), (ev_fresh, st_fresh) = runs["follower"], runs["fresh"]
    assert ev == ev_fresh and torch.equal(st, st_fresh)
    assert runs["other seed"][0] != ev


def test_cache_is_reset_in_place_and_kept_per_signature(models):
    """A later scheduler of one signature takes the entry's tensors at
    their addresses, every one zeroed as ``init_cache`` makes it; another
    ``n_pages`` or KV dtype gets a cache of its own, and the first
    signature's entry is still there after them."""
    _, _, model, _ = models
    kw = dict(PAGED, n_slots=3, max_len=20, n_pages=9, int8=True)
    first, _ = _port(models, _wave(6), **kw)
    ptrs = {k: t.data_ptr() for k, t in first.cache.items()}
    assert any(bool(t.any()) for t in first.cache.values()), "the run wrote nothing"
    later = SlotScheduler(model, models[3], shared_programs=True,
                          kv_dtype=torch.int8, **{k: v for k, v in kw.items()
                                                   if k != "int8"})
    fresh = model.init_cache(3, 20, kv_dtype=torch.int8, paged=True,
                             page_size=4, n_pages=9)
    assert {k: t.data_ptr() for k, t in later.cache.items()} == ptrs
    assert set(later.cache) == set(fresh) == {"k", "v", "pos", "block_table",
                                              "k_scale", "v_scale"}
    for k, t in fresh.items():
        assert torch.equal(later.cache[k], t), k
    other_pages, _ = _port(models, _wave(7), **dict(kw, n_pages=10))
    other_dtype, _ = _port(models, _wave(7), **dict(kw, int8=False))
    for other in (other_pages, other_dtype):
        assert other.cache["k"].data_ptr() != ptrs["k"]
    again, _ = _port(models, _wave(8), **kw)
    assert {k: t.data_ptr() for k, t in again.cache.items()} == ptrs


def test_superseded_scheduler_raises_before_it_writes(models):
    """Once a newer scheduler took the entry, the older one raises on
    its next run (and on a direct program call) without touching the
    newer one's cache; its finished result and store stay readable, and
    the newer one serves what a fresh unshared scheduler serves."""
    kw = dict(PAGED, n_pages=8)
    old, old_res = _port(models, _wave(9), **kw)
    _, _, model, params = models
    new = SlotScheduler(model, params, shared_programs=True, **kw)
    for r in _wave(10):
        new.submit(SessionRequest(*r))
    new.tick()
    snapshot = {k: t.clone() for k, t in new.cache.items()}
    old.submit(SessionRequest("late", np.arange(6, dtype=np.int32), 3))
    with pytest.raises(RuntimeError, match="newer scheduler"):
        old.run()
    with pytest.raises(RuntimeError, match="newer scheduler"):
        old._progs.copy_page(old.cache, 1, 2)
    for k, t in new.cache.items():
        assert torch.equal(t, snapshot[k]), k
    assert old_res.run_tokens == sum(len(s.tokens) for s in old_res.sessions.values())
    old.flush_prefix_cache()
    assert old.store.allocator.n_free == old.store.n_pages - 1
    got = new.run()
    _, want = _port(models, _wave(10), shared=False, **kw)
    assert got.events == want.events


def test_unshared_schedulers_allocate_their_own_caches(models):
    """``shared_programs=False`` (the default): each scheduler makes its
    own cache and generator, and the model's shared entries stay as they
    were."""
    _, _, model, params = models
    kw = dict(PAGED, n_pages=8)
    shared, _ = _port(models, _wave(11), **kw)
    entries = dict(model.__dict__.get("_shared_sched_programs", {}))
    a, res_a = _port(models, _wave(11), shared=False, **kw)
    b = SlotScheduler(model, params, **kw)
    ptrs = [s.cache["k"].data_ptr() for s in (shared, a, b)]
    assert len(set(ptrs)) == 3
    assert a.gen is not b.gen and a.gen is not shared.gen
    assert model.__dict__.get("_shared_sched_programs", {}) == entries
    assert a._progs.raw_step_cache_size() is None
