"""The port's host-DRAM KV page tier against the JAX package's, on the CPU.

Mirrors ``tests/test_kv_tiering.py``: save/restore fidelity (bit-exact,
in place: the pools keep their tensors), the host pool's accounting
(LRU, reserve, pinned against unpinned entries, ``on_drop``; rows
handed out once and adopted by a put without a copy), the store-level
eviction and resume interplay, and end to end the port's
``SlotScheduler`` against the JAX one on the same requests: every tier
policy, the pure park/restore path, a full host pool, restore patience,
int8 KV at K=4 and priority preemption off give equal event logs, greedy
streams and tier counters, and both pools balance afterwards.

A small qwen2.5-3b-shaped config in f32 (vocab 64, d_model 64, 2
layers), the same bridged weights on both sides.
"""
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving import SessionRequest as JaxRequest
from repro.serving import SlotScheduler as JaxScheduler
from repro.serving.memory import tiers as jax_tiers
from repro_torch.bridge import from_jax_params, to_tensor
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import SessionRequest, SlotScheduler
from repro_torch.serving.memory import (HostPagePool, TieredPageStore,
                                        blob_checksum, get_policy,
                                        restore_kv_blobs, save_kv_blobs)

SHAPE = dict(vocab_size=64, d_model=64, d_ff=128, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, dtype="float32")
COUNTERS = ("ticks", "decode_steps", "preemptions", "prefill_tokens",
            "prefix_hits", "prefix_tokens_saved", "cow_copies",
            "step_kv_blocks", "horizon_hist", "now_s", "kv_tier",
            "tier_policy", "pages_spilled", "pages_restored", "tier_restores",
            "host_prefix_hits", "host_pages_used", "fault_counts",
            "faults_injected", "save_retries", "restore_retries",
            "degraded_restores", "corrupt_blobs", "quarantines",
            "aborted_sessions", "failed_sessions", "expired_sessions",
            "audit_failures", "retry_backoff_s")


@pytest.fixture(scope="module")
def models():
    """(JAX model, params) by route and the port's (model, params) on the
    CPU, over the same weights."""
    jcfg = jax_get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    cfg = get_config("qwen2.5-3b").reduced().replace(**SHAPE)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(11))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             "cpu")
    jax_models = {r: JaxModel(jcfg, decode_backend=r) for r in ("sdpa", "pallas")}
    return jax_models, jparams, Model(cfg, device="cpu"), params


def _churn(n=5):
    """Deterministic wave sized to thrash a small pool: multi-page
    prompts, budgets long enough that residents preempt each other."""
    rng = np.random.RandomState(3)
    return [(f"s{i}", rng.randint(0, 64, size=8 + 3 * (i % 3)).astype(np.int32),
             6 + 2 * (i % 2)) for i in range(n)]


def _pair(models, reqs, *, route="sdpa", int8=False, **kw):
    """Serve ``reqs`` through the JAX scheduler and the port's with the
    same arguments (``int8``: int8 KV on both); both must give the same
    events, streams, statuses, stamps and counters.  Returns (JAX result,
    port scheduler, port result)."""
    jax_models, jparams, model, params = models
    kw = dict(dict(n_slots=2, max_len=24, paged=True, page_size=4,
                   timed=False), **kw)
    ref_s = JaxScheduler(jax_models[route], jparams, shared_programs=True,
                         kv_dtype=jnp.int8 if int8 else None, **kw)
    sched = SlotScheduler(model, params, kv_dtype=torch.int8 if int8 else None,
                          **kw)
    for r in reqs:
        ref_s.submit(JaxRequest(*r))
        sched.submit(SessionRequest(*r))
    ref, got = ref_s.run(), sched.run()
    assert got.events == ref.events
    for sid in ref.sessions:
        a, b = ref.sessions[sid], got.sessions[sid]
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=sid)
        np.testing.assert_array_equal(b.token_times_s, a.token_times_s)
        assert (b.status, b.ttft_s, b.arrival_s) == (a.status, a.ttft_s,
                                                     a.arrival_s), sid
    for field in COUNTERS:
        assert getattr(got, field) == getattr(ref, field), field
    return ref, sched, got


def _assert_balanced(sched):
    sched.flush_prefix_cache()
    sched.store.flush_host()
    assert sched.store.allocator.n_free == sched.store.n_pages - 1, "page leak"
    assert sched.store.host_used == 0, "host blob leak"


# ------------------------------------------------------- page movers
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_blob_checksum_matches_the_reference(dtype):
    """Equal bytes give equal checksums: the CRC chains over each
    component's bytes in the reference's order."""
    rng = np.random.default_rng(0)
    ref_blob = (jnp.asarray(rng.standard_normal((2, 4, 2, 3)),
                            jnp.dtype(dtype) if dtype != "int8" else jnp.int8),
                jnp.asarray(rng.standard_normal((2, 4, 2)), jnp.float32))
    ref_blob = tuple(np.asarray(c) for c in ref_blob)
    blob = tuple(to_tensor(c, "cpu") for c in ref_blob)
    assert blob_checksum(blob) == jax_tiers.blob_checksum(ref_blob)
    assert blob_checksum(blob) == zlib.crc32(
        ref_blob[1].tobytes(), zlib.crc32(ref_blob[0].tobytes()))


def _random_pools(model, kv_dtype, seed=0):
    cache = model.init_cache(2, 16, kv_dtype=kv_dtype, paged=True, page_size=4,
                             n_pages=8)
    g = torch.Generator().manual_seed(seed)
    for key in model._page_slab_keys(cache):
        t = cache[key]
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    return cache


@pytest.mark.parametrize("kv_dtype", [None, torch.int8], ids=["f32", "int8"])
@pytest.mark.parametrize("pooled", [False, True], ids=["fresh", "pool_rows"])
def test_save_restore_roundtrip_is_bit_exact_in_place(models, kv_dtype, pooled):
    """save -> clobber -> restore gives back the original page bytes,
    codes and scales alike; the pools keep their tensors (a captured
    graph reads them at fixed addresses); pages not restored stay
    clobbered; the blobs equal the reference's ``save_kv_pages`` slabs."""
    jax_models, _, model, _ = models
    cache = _random_pools(model, kv_dtype)
    keys = model._page_slab_keys(cache)
    orig = {k: cache[k].clone() for k in keys}
    ptrs = {k: cache[k].data_ptr() for k in keys}
    pages = [3, 5, 6]
    pool = HostPagePool(4) if pooled else None
    blobs = save_kv_blobs(model.save_kv_pages, cache, pages, pool)
    jcache = {k: jnp.asarray(orig[k].numpy()) for k in keys}
    jcache["block_table"] = jnp.zeros((2, 4), jnp.int32)
    ref = jax_models["sdpa"].save_kv_pages(jcache, jnp.asarray(pages))
    for i, blob in enumerate(blobs):
        assert len(blob) == len(keys)
        for c, comp in enumerate(blob):
            np.testing.assert_array_equal(comp.numpy(), np.asarray(ref[c][:, i]))
    if pooled:      # the rows the next puts take: adopted without a copy
        handles = [pool.put(b, pinned=True) for b in blobs]
        assert [pool.get(h)[0].data_ptr() for h in handles] == \
            [b[0].data_ptr() for b in blobs]
    for k in keys:
        cache[k].zero_()
    out = restore_kv_blobs(model.restore_kv_pages, cache, pages, blobs)
    assert out is cache
    for k in keys:
        assert cache[k].data_ptr() == ptrs[k], f"{k} moved"
        for p in pages:
            assert torch.equal(cache[k][:, p], orig[k][:, p]), (k, p)
        assert not cache[k][:, 2].any(), "a page nobody restored changed"


def test_copies_move_exactly_the_pages_asked_for(models):
    """No power-of-two padding: each save gathers exactly its pages, in
    order (the reference pads and slices the pad off, so page counts
    agree)."""
    _, _, model, _ = models
    cache = _random_pools(model, None)
    seen = []

    def spy(c, ids):
        seen.append(ids.tolist())
        return model.save_kv_pages(c, ids)

    for n in range(1, 6):
        assert len(save_kv_blobs(spy, cache, list(range(1, n + 1)))) == n
    assert seen == [list(range(1, n + 1)) for n in range(1, 6)]


# ------------------------------------------------------ host pool
def _blob(i, mod):
    if mod is jax_tiers:
        return (np.full((1,), i, np.float32), np.zeros((1,), np.float32))
    return (torch.full((1,), float(i)), torch.zeros(1))


@pytest.mark.parametrize("seed", range(4))
def test_host_pool_walk_matches_the_reference(seed):
    """Seeded random puts (pinned or not), touches, gets, pops and
    reserves: handles, evictions, ``on_drop`` calls and contents match
    the reference pool's."""
    logs = []
    for mod, Pool in ((jax_tiers, jax_tiers.HostPagePool), (None, HostPagePool)):
        rnd = random.Random(seed)
        pool, live, log, dropped = Pool(5), [], [], []
        pool.on_drop = dropped.append
        for step in range(200):
            op = rnd.choice(["put", "put", "touch", "get", "pop", "reserve"])
            if op == "put":
                h = pool.put(_blob(step, mod), pinned=rnd.random() < 0.3)
                log.append(("put", h))
                if h is not None:
                    live.append(h)
            elif op == "reserve":
                log.append(("reserve", pool.reserve(rnd.randint(1, 3))))
            elif live:
                h = live[rnd.randrange(len(live))]
                if op == "touch":
                    pool.touch(h)
                else:
                    try:
                        val = float((pool.pop(h) if op == "pop" else pool.get(h))[0][0])
                        log.append((op, h, val))
                        if op == "pop":
                            live.remove(h)
                    except KeyError:        # evicted since
                        live.remove(h)
                        log.append((op, h, "gone"))
            log.append((pool.used, pool.free, pool.spilled, pool.dropped,
                        tuple(dropped)))
        logs.append(log)
    assert logs[0] == logs[1]


class TestHostPagePool:
    def test_pinned_survive_lru_unpinned_die(self):
        pool = HostPagePool(3)
        hp = pool.put(_blob(0, None), pinned=True)
        h1 = pool.put(_blob(1, None), pinned=False)
        h2 = pool.put(_blob(2, None), pinned=False)
        pool.touch(h1)                   # h2 becomes the LRU victim
        dropped = []
        pool.on_drop = dropped.append
        h3 = pool.put(_blob(3, None), pinned=False)
        assert dropped == [h2] and pool.dropped == 1
        assert pool.get(hp)[0][0] == 0 and pool.get(h1)[0][0] == 1
        assert pool.get(h3)[0][0] == 3
        with pytest.raises(KeyError):
            pool.get(h2)

    def test_reserve_fails_when_pinned_fill(self):
        pool = HostPagePool(2)
        pool.put(_blob(0, None), pinned=True)
        pool.put(_blob(1, None), pinned=True)
        assert not pool.reserve(1)
        assert pool.put(_blob(2, None), pinned=False) is None
        assert pool.used == 2            # failed put changes nothing

    def test_pop_releases_capacity_and_row(self):
        pool = HostPagePool(1)
        h = pool.put(_blob(7, None), pinned=True)
        assert pool.free == 0 and pool.staging(1, _blob(0, None)) is None
        assert pool.pop(h)[0][0] == 7
        assert pool.free == 1 and pool.used == 0
        (row,) = pool.staging(1, _blob(0, None))
        h2 = pool.put(row, pinned=True)
        assert pool.get(h2)[0].data_ptr() == row[0].data_ptr()

    def test_rows_are_allocated_once_and_refuse_another_layout(self):
        pool = HostPagePool(3)
        first = pool.staging(3, _blob(0, None))
        ptrs = [b[0].data_ptr() for b in first]
        assert ptrs == sorted(ptrs) and len(set(ptrs)) == 3
        for i in range(3):
            pool.put(_blob(i, None), pinned=False)
        assert [pool.get(h)[0].data_ptr() for h in range(3)] == ptrs
        with pytest.raises(ValueError, match="layout"):
            pool.replace(0, (torch.zeros(2), torch.zeros(1)))


# -------------------------------------- store-level eviction interplay
def _fake_store(**kw):
    """TieredPageStore over fake page movers: blobs are (page_id,)
    sentinels, so restores are checkable without a model."""
    moved = {"restored": []}

    def save_fn(cache, pages):
        return [(torch.full((1,), float(p)), torch.zeros(1)) for p in pages]

    def restore_fn(cache, pages, blobs):
        moved["restored"].extend((int(b[0][0]), p) for p, b in zip(pages, blobs))
        return cache

    store = TieredPageStore(
        n_slots=2, max_blocks=6, page_size=4, n_pages=10, prefix_cache=True,
        host_pages=kw.pop("host_pages", 8),
        policy=get_policy(kw.pop("policy", "spill")),
        save_fn=save_fn, restore_fn=restore_fn, get_cache=lambda: {}, **kw)
    return store, moved


class TestEvictionResumeInterplay:
    def test_prefix_reclaim_mid_parking_spills_then_resumes(self):
        store, moved = _fake_store()
        seq = np.asarray([1] * 8, np.int32)
        pages = store.alloc(3)
        store.register(seq, pages, 2)
        store.park("sid", 2, pages, {})
        store.release(pages)
        assert store.parked_blocks("sid") == 2 and store.pages_spilled == 2
        got = store.alloc(9)                   # > free list alone
        assert got is not None
        assert len(store.host_match(seq, 0, 2)) >= 1
        assert store.pages_spilled - 2 >= 1
        store.release(got)
        fresh = store.alloc(2)
        store.take_parked("sid", 0, fresh, {})
        assert store.tier_restores == 1
        assert [m[0] for m in moved["restored"]] == pages[:2]
        store.release(fresh)
        store.flush_prefix()
        store.flush_host()
        assert store.allocator.n_free == store.n_pages - 1
        assert store.host_used == 0

    def test_host_index_restore_consumes_entry(self):
        store, _ = _fake_store()
        seq = np.asarray([2] * 8, np.int32)
        pages = store.alloc(2)
        store.register(seq, pages, 2)
        store.release(pages)
        store.prefix.reclaim(99)
        paths = store.host_match(seq, 0, 2)
        assert len(paths) == 2
        fresh = store.alloc(2)
        store.restore_host_prefix(paths, fresh, {})
        assert store.host_prefix_hits == 2
        assert store.host_match(seq, 0, 2) == []
        store.release(fresh)
        store.flush_host()
        assert store.host_used == 0

    def test_prefer_device_never_touches_the_host(self):
        store, _ = _fake_store(policy="prefer-device")
        seq = np.asarray([3] * 8, np.int32)
        pages = store.alloc(2)
        store.register(seq, pages, 2)
        store.release(pages)
        store.prefix.reclaim(99)
        assert store.pages_spilled == 0 and store.host_used == 0
        assert store.host_match(seq, 0, 2) == []

    def test_double_park_raises(self):
        store, _ = _fake_store()
        pages = store.alloc(2)
        store.park("sid", 2, pages, {})
        with pytest.raises(RuntimeError, match="parked twice"):
            store.park("sid", 2, pages, {})

    def test_park_fails_clean_when_host_full(self):
        store, _ = _fake_store(host_pages=1)
        a = store.alloc(2)
        assert store.park("a", 2, a, {}) is None
        assert store.park_fails == 1
        assert store.parked_blocks("a") == 0 and store.host_used == 0

    def test_shadow_spill_consumed_by_park(self):
        store, moved = _fake_store(policy="lookahead")
        pages = store.alloc(3)
        store.shadow_spill("sid", [0, 1], pages[:2], {})
        assert store.pages_spilled == 2
        assert store.park("sid", 3, pages, {}) == 1
        fresh = store.alloc(3)
        store.take_parked("sid", 0, fresh, {})
        assert [m[0] for m in moved["restored"]] == pages
        store.release(pages)
        store.release(fresh)
        assert store.host_used == 0


# ------------------------------------------- scheduler against the JAX one
@pytest.mark.parametrize("route", ["sdpa", "pallas"])
def test_tier_arms_match_the_reference_and_the_single_tier_streams(models, route):
    """Forced preemption churn through a small pool with the prefix
    cache on: the single-tier run and every tier policy give the JAX
    scheduler's events, streams and counters; every arm replays the
    single-tier greedy streams; the spill arms migrate; both pools
    balance."""
    reqs = _churn()
    kw = dict(n_pages=8, prefill_chunk=4, prefix_cache=True, route=route)
    base, sched, _ = _pair(models, reqs, **kw)
    assert base.preemptions > 0, "pool never pressured: test is void"
    for arm in ("prefer-device", "spill", "lookahead"):
        _, sched, res = _pair(models, reqs, kv_tier="host", tier_policy=arm,
                                host_pages=24, **kw)
        for r in reqs:
            np.testing.assert_array_equal(res.tokens_for(r[0]),
                                          base.tokens_for(r[0]))
        if arm == "prefer-device":
            assert res.pages_spilled == 0 and res.tier_restores == 0
            assert res.prefill_tokens == base.prefill_tokens
        else:
            assert res.pages_spilled > 0 and res.tier_restores > 0
            assert res.prefill_tokens < base.prefill_tokens
        _assert_balanced(sched)


@pytest.mark.parametrize("case", ["no_prefix_cache", "tiny_host_pool",
                                  "restore_patience", "int8_k4",
                                  "fifo_preemption"])
def test_tier_paths_match_the_reference(models, case):
    """The pure park/restore path (no device prefix match), a 1-page
    host pool (parks fail, re-prefill takes over), restore patience on a
    pool too small to restore at once, int8 KV under K=4 macro-ticks,
    and youngest-first preemption."""
    reqs = _churn(4)
    kw = dict(n_pages=8, prefill_chunk=4, kv_tier="host", host_pages=24)
    if case == "tiny_host_pool":
        kw["host_pages"] = 1
    elif case == "restore_patience":
        kw.update(n_pages=7, restore_patience=2)
    elif case == "int8_k4":
        kw.update(steps_per_tick=4, int8=True, n_pages=7)
    elif case == "fifo_preemption":
        kw["priority_preemption"] = False
    _, sched, res = _pair(models, reqs, **kw)
    assert res.preemptions > 0
    if case == "tiny_host_pool":
        assert res.tier_restores == 0
    else:
        assert res.tier_restores > 0
    _assert_balanced(sched)

