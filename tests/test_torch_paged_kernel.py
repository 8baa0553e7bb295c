"""The port's paged decode attention (``repro_torch.kernels.
paged_decode_attention``) on CPU tensors — its plain version — against
the JAX package's Pallas kernel in interpret mode and its ``ref.py``
oracle, on the same numpy inputs; and the analytic traffic accounting
against the reference's.

Tolerance: 1e-5 absolute and relative in f32 (the two frameworks sum
the dot products in different orders; values are O(1)).  A poisoned
garbage page must leave the output bit-equal: it is never read.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.paged_decode_attention import ops as jax_ops
from repro.kernels.paged_decode_attention import ref as jax_ref
from repro_torch.configs import get_config
from repro_torch.kernels.paged_decode_attention import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B, Hq, Hkv, hd, page, max_blocks, lengths, quant=False):
    """Numpy inputs: pools with a shuffled block table whose blocks past
    each length point at the garbage page 0."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_blocks
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    shape = (n_pages, page, Hkv, hd)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (0.02 * rng.random(shape[:3])).astype(np.float32)
        vs = (0.02 * rng.random(shape[:3])).astype(np.float32)
        scales = (ks, vs)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        scales = (None, None)
    bt = (rng.permutation(n_pages - 1) + 1)[:B * max_blocks].reshape(B, max_blocks)
    lens = np.asarray(lengths, np.int32)
    live = np.arange(max_blocks)[None] * page < lens[:, None]
    return q, k, v, np.where(live, bt, 0).astype(np.int32), lens, scales


def _port(q, k, v, bt, lens, scales):
    t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, bt, lens) + tuple(scales)]
    return ops.paged_decode_attention(*t).numpy()


def _jax(q, k, v, bt, lens, scales):
    j = [None if a is None else jnp.asarray(a)
         for a in (q, k, v, bt, lens) + tuple(scales)]
    return np.asarray(jax_ops.paged_decode_attention(*j))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page", [4, 8, 16])
def test_matches_jax_kernel_and_oracle(page, quant):
    max_blocks = 4
    inputs = _case(page, 3, 8, 2, 32, page, max_blocks,
                   [max_blocks * page, 2 * page + page // 2, 1], quant)
    got = _port(*inputs)
    np.testing.assert_allclose(got, _jax(*inputs), **TOL)
    q, k, v, bt, lens, (ks, vs) = map(
        lambda a: a if isinstance(a, tuple) else jnp.asarray(a), inputs)
    oracle = (jax_ref.paged_decode_attention_quant_ref(
        q, k, v, jnp.asarray(ks), jnp.asarray(vs), bt, lens) if quant
        else jax_ref.paged_decode_attention_ref(q, k, v, bt, lens))
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_partial_last_page_every_offset(quant):
    page, max_blocks = 8, 2
    q, k, v, _, _, scales = _case(7, 1, 4, 2, 32, page, max_blocks,
                                  [max_blocks * page], quant)
    bt = np.asarray([[2, 1]], np.int32)
    for length in range(1, max_blocks * page + 1):
        lens = np.asarray([length], np.int32)
        np.testing.assert_allclose(_port(q, k, v, bt, lens, scales),
                                   _jax(q, k, v, bt, lens, scales), **TOL,
                                   err_msg=f"length={length}")


@pytest.mark.parametrize("quant", [False, True])
def test_sentinel_blocks_never_read_and_free_lane_zeros(quant):
    """Blocks past a slot's length park on page 0; poisoning it changes
    no output bit.  A length-0 lane gives zeros."""
    q, k, v, bt, lens, scales = _case(11, 3, 4, 2, 32, 4, 4, [8, 11, 0], quant)
    assert (bt[0, 2:] == 0).all() and (bt[2] == 0).all()
    clean = _port(q, k, v, bt, lens, scales)
    np.testing.assert_allclose(clean, _jax(q, k, v, bt, lens, scales), **TOL)
    assert (clean[2] == 0).all()
    k, v = k.copy(), v.copy()
    k[0], v[0] = (100, -100) if quant else (1e9, -1e9)
    if quant:
        scales = tuple(s.copy() for s in scales)
        scales[0][0] = scales[1][0] = 1e9
    np.testing.assert_array_equal(_port(q, k, v, bt, lens, scales), clean)


def test_int8_all_zero_row():
    """Pages whose scales are all zero (an all-zero K/V row quantises to
    codes 0 and scale 1e-12) dequantise to exact zeros on both sides."""
    q, k, v, bt, lens, (ks, vs) = _case(5, 2, 8, 2, 64, 8, 3, [20, 9], True)
    live_page = int(bt[0, 0])
    k[live_page] = 0
    v[live_page] = 0
    ks, vs = ks.copy(), vs.copy()
    ks[live_page] = vs[live_page] = 1e-12
    got = _port(q, k, v, bt, lens, (ks, vs))
    np.testing.assert_allclose(got, _jax(q, k, v, bt, lens, (ks, vs)), **TOL)


def test_bf16_pool_follows_q_dtype():
    q, k, v, bt, lens, scales = _case(3, 2, 8, 2, 64, 8, 2, [16, 11])
    t = [torch.from_numpy(a) for a in (q, k, v, bt, lens)]
    out = ops.paged_decode_attention(t[0].bfloat16(), t[1].bfloat16(),
                                     t[2].bfloat16(), t[3], t[4])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               _jax(q, k, v, bt, lens, scales), atol=0.05)


def test_ref_is_the_gather_route():
    q, k, v, bt, lens, _ = _case(9, 2, 4, 4, 32, 4, 3, [12, 5])
    t = [torch.from_numpy(a) for a in (q, k, v, bt, lens)]
    np.testing.assert_allclose(ref.paged_decode_attention_ref(*t).numpy(),
                               np.asarray(jax_ref.paged_decode_attention_ref(
                                   *map(jnp.asarray, (q, k, v, bt, lens)))),
                               **TOL)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_traffic_accounting_equals_reference(kv_quant):
    kw = dict(n_slots=4, max_blocks=5, n_layers=3, kv_bytes=2,
              kv_quant=kv_quant)
    assert ops.traffic_bytes(7, 8, 2, 64, **kw) == \
        jax_ops.traffic_bytes(7, 8, 2, 64, **kw)
    for name in ("qwen2.5-7b", "qwen2.5-3b"):
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(name).replace(dtype=dtype)
            jcfg = jax_get_config(name).replace(dtype=dtype)
            kw2 = dict(page_size=16, n_slots=4, max_blocks=131,
                       kv_quant=kv_quant)
            trace = [130, 132, 133, 135]
            assert ops.serving_traffic_bytes(trace, cfg, **kw2) == \
                jax_ops.serving_traffic_bytes(trace, jcfg, **kw2)
    assert ops.kv_token_bytes(4, 128, 2, kv_quant) == \
        jax_ops.kv_token_bytes(4, 128, 2, kv_quant)


@pytest.mark.parametrize("B,Hkv", [(1, 1), (2, 4), (4, 4), (8, 2), (64, 8)])
@pytest.mark.parametrize("page", [4, 8, 16, 32])
def test_mma_split_range_covers_live_tokens(page, B, Hkv):
    """The mma path's splits, as the kernel cuts them (``split_range``),
    cover each slot's live tokens once, in split order, in whole
    16-token units whose runs differ by at most one unit, for every
    length from 0 to the virtual span."""
    S = 9 * page
    n_split = ops.mma_split_plan(B, Hkv, S, 132, quant=B % 2 == 0)
    for length in range(S + 1):
        ranges = [ops.split_range(length, s, n_split) for s in range(n_split)]
        live = [(a, b) for a, b in ranges if a < b]
        covered = [t for a, b in live for t in range(a, b)]
        assert covered == list(range(length)), (length, ranges)
        units = [-(-(b - a) // ops.MMA_UNIT) for a, b in ranges]
        assert max(units) - min(units) <= 1
        assert all(a % ops.MMA_UNIT == 0 for a, _ in live)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,Hkv,S", [
    (4, 4, 2176), (1, 4, 2176), (4, 4, 64), (2, 4, 96), (3, 2, 24),
    (1, 1, 1 << 20), (66, 4, 2176), (4096, 1, 512)])
def test_mma_split_plan_fits_one_wave(B, Hkv, S, quant):
    """The mma grid gives each of 132 SMs at most one block (bf16 pools)
    or two (int8), all resident at once, unless one split per pair is
    already more; no split is planned past the virtual span's 16-token
    units; the serving shape (4 slots, 4 KV heads) gets 8 splits per pair
    over bf16 pools and 16 over int8."""
    n_split = ops.mma_split_plan(B, Hkv, S, 132, quant)
    assert 1 <= n_split <= ops.MMA_MAX_SPLIT
    assert n_split <= -(-S // ops.MMA_UNIT)
    assert n_split * B * Hkv <= ops.MMA_BLOCKS_PER_SM[quant] * 132 or n_split == 1
    if (B, Hkv, S) == (4, 4, 2176):
        assert n_split == (16 if quant else 8)


@pytest.mark.parametrize("q_dtype,pool_dtype,path", [
    (torch.bfloat16, torch.bfloat16, "mma"), (torch.bfloat16, torch.int8, "mma"),
    (torch.float32, torch.float32, "cuda_core"),
    (torch.float32, torch.int8, "cuda_core")])
def test_path_for(q_dtype, pool_dtype, path):
    q = torch.zeros((1, 4, 32), dtype=q_dtype)
    assert ops.path_for(q, torch.zeros((2, 4, 1, 32), dtype=pool_dtype)) == path
