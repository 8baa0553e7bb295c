"""Decode attention: the port's plain version against the JAX oracle
(``decode_attention_ref``) and the JAX Pallas kernel in interpret mode,
on the same numpy inputs.  The CUDA kernel is held against the plain
version on the card in test_torch_cuda_kernels.py.

Tolerance: f32 on the CPU, 1e-5 (sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SHAPES = [  # tests/test_kernels.py::TestDecodeAttention shapes
    (1, 28, 4, 128, 512),
    (2, 8, 2, 64, 256),
    (3, 16, 4, 64, 384),
    (2, 4, 4, 128, 128),
    (1, 2, 1, 32, 96),
]


def _inputs(B, Hq, Hkv, hd, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,Hq,Hkv,hd,S", SHAPES)
def test_plain_matches_jax_ref_and_kernel(B, Hq, Hkv, hd, S):
    q, k, v = _inputs(B, Hq, Hkv, hd, S, seed=B * S + Hq)
    mask = np.arange(S) <= (S * 2) // 3
    out = decode_attention_ref(*_t(q, k, v), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 mask=jnp.asarray(mask), block=128))
    np.testing.assert_allclose(out, kern, rtol=1e-5, atol=1e-5)


def test_per_sequence_mask_and_fully_masked_row():
    """A (B, S) mask; row 1 has no valid slot and must give zeros, as the
    JAX kernel's ``acc / max(l, 1e-30)`` does."""
    B, Hq, Hkv, hd, S = 3, 8, 2, 32, 160
    q, k, v = _inputs(B, Hq, Hkv, hd, S, seed=7)
    rng = np.random.default_rng(8)
    mask = rng.random((B, S)) < 0.5
    mask[1] = False
    out = decode_attention_ref(*_t(q, k, v), torch.from_numpy(mask)).numpy()
    kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 mask=jnp.asarray(mask), block=64))
    np.testing.assert_allclose(out, kern, rtol=1e-5, atol=1e-5)
    assert np.all(out[1] == 0)
    for b in (0, 2):
        ref = np.asarray(jax_ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                 jnp.asarray(v[b:b + 1]), jnp.asarray(mask[b])))
        np.testing.assert_allclose(out[b:b + 1], ref, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    q, k, v = _t(*_inputs(1, 4, 2, 32, 64))
    mask = torch.arange(64) < 40
    before = ops.launches
    torch.testing.assert_close(ops.decode_attention(q, k, v, mask),
                               decode_attention_ref(q, k, v, mask))
    assert ops.launches == before


def test_split_plan_covers_the_sequence():
    for S in [17, 2048, 2081, 32768, 10**6]:
        n_split, chunk = ops.split_plan(S)
        assert chunk % ops.TILE == 0 and (n_split - 1) * chunk < S <= n_split * chunk
        assert n_split <= ops.MAX_SPLIT


# ---------------------------------------------------------------- the mma path's plan
N_SM = 132   # an H100's SMs: what the split plan fills


@pytest.mark.parametrize("pairs", [4, 32, 128])
def test_mma_split_range_covers_the_sequence_once(pairs):
    """For every S from 1 to 2081: the splits' ranges are whole 16-token
    units (the last clipped to S), in split order, cover [0, S) once,
    and differ by at most one unit."""
    for S in range(1, 2082):
        n_split = ops.mma_split_plan(1, pairs, S, N_SM)
        assert 1 <= n_split <= min(ops.MMA_MAX_SPLIT, -(-S // ops.MMA_UNIT))
        ranges = [ops.split_range(S, i, n_split) for i in range(n_split)]
        assert ranges[0][0] == 0 and ranges[-1][1] == S
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        units = [-(-(s1 - s0) // ops.MMA_UNIT) for s0, s1 in ranges]
        assert all(s0 % ops.MMA_UNIT == 0 and s1 > s0 for s0, s1 in ranges)
        assert max(units) - min(units) <= 1


def test_mma_split_plan_at_the_main_shapes_fits_one_wave():
    """qwen2.5-7b batch-1 (Hkv 4, S 2081): 33 splits of at most 64 slots,
    132 blocks, one per SM; zamba2-1.2b's shared block (Hkv 32): 4."""
    n_split = ops.mma_split_plan(1, 4, 2081, N_SM)
    assert n_split == 33 and n_split * 4 <= N_SM
    assert max(s1 - s0 for s0, s1 in (ops.split_range(2081, i, n_split)
                                      for i in range(n_split))) <= ops.MMA_TILE
    assert ops.mma_split_plan(1, 32, 2081, N_SM) == 4
    assert ops.mma_split_plan(64, 4, 2081, N_SM) == 1


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"),
                                        (torch.float32, "cuda_core")])
def test_path_for(dtype, path):
    q = torch.zeros((1, 4, 32), dtype=dtype)
    k = torch.zeros((1, 8, 2, 32), dtype=dtype)
    assert ops.path_for(q, k) == path


def _mma_emulation(q, k, v, mask):
    """The mma path's algorithm in f32 numpy, as the kernel runs it: per
    (b, KV head) the splits of ``mma_split_plan``; per split its 64-token
    tiles from s0, a tile with no valid slot skipped; in a tile four
    16-slot units, each with its own online softmax (base 2, masked
    columns p = 0, a unit with no valid slot skipped), combined at the
    split's end into one partial (m, l, acc); the partials merged in
    split order.  Returns (B, Hq, hd) and the number of skipped tiles."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    valid = np.broadcast_to(np.asarray(mask).reshape(-1, S) != 0, (B, S))
    scale = np.float32(np.log2(np.e) / np.sqrt(hd))
    neg = np.float32(-1e30)
    n_split = ops.mma_split_plan(B, Hkv, S, N_SM)
    out = np.zeros((B, Hq, hd), np.float32)
    skipped = 0
    for b in range(B):
        for h in range(Hkv):
            qh = q[b, h * G:(h + 1) * G]                      # (G, hd)
            parts = []
            for split in range(n_split):
                s0, s1 = ops.split_range(S, split, n_split)
                m = np.full((4, G), neg, np.float32)
                l = np.zeros((4, G), np.float32)
                acc = np.zeros((4, G, hd), np.float32)
                for t0 in range(s0, s1, ops.MMA_TILE):
                    if not valid[b, t0:min(t0 + ops.MMA_TILE, s1)].any():
                        skipped += 1
                        continue
                    for w in range(4):
                        u0 = t0 + 16 * w
                        u1 = min(u0 + 16, s1)
                        ok = valid[b, u0:u1] if u0 < s1 else np.zeros(0, bool)
                        if not ok.any():
                            continue
                        s = (qh @ k[b, u0:u1, h].T) * scale       # (G, n)
                        s = np.where(ok, s, neg)
                        m_new = np.maximum(m[w], s.max(axis=1))
                        alpha = np.exp2(m[w] - m_new)
                        p = np.where(ok, np.exp2(s - m_new[:, None]), 0)
                        l[w] = l[w] * alpha + p.sum(axis=1)
                        acc[w] = acc[w] * alpha[:, None] + p @ v[b, u0:u1, h]
                        m[w] = m_new
                M = m.max(axis=0)
                e = np.exp2(m - M)
                parts.append((M, (e * l).sum(axis=0), (e[:, :, None] * acc).sum(axis=0)))
            M = np.max([p[0] for p in parts], axis=0)
            lsum = np.zeros(G, np.float32)
            asum = np.zeros((G, hd), np.float32)
            for m_s, l_s, a_s in parts:                        # split order
                e = np.exp2(m_s - M)
                lsum += e * l_s
                asum += e[:, None] * a_s
            out[b, h * G:(h + 1) * G] = asum / np.maximum(lsum, 1e-30)[:, None]
    return out, skipped


@pytest.mark.parametrize("B,Hq,Hkv,hd,S,kind", [
    (2, 16, 8, 32, 2081, "holes"),     # 8 splits of ~260 slots: whole splits empty
    (1, 28, 4, 128, 520, "prefix"),    # the main path's prefix mask, G 7
    (3, 4, 4, 64, 700, "holes"),       # G 1, 11 splits
])
def test_mma_emulation_matches_pallas_and_ref(B, Hq, Hkv, hd, S, kind):
    """The mma path's algorithm (a test-only f32 emulation) against the
    JAX kernel in interpret mode and the JAX oracle, on the same numpy
    inputs, at 1e-5: masks that leave whole tiles and splits empty, and
    (B > 1) a row with no valid slot, which must give zeros as the
    kernel's do (the oracle, unguarded, gives NaN there: it is held to
    the rows with a valid slot)."""
    q, k, v = _inputs(B, Hq, Hkv, hd, S, seed=S + hd)
    rng = np.random.default_rng(S)
    if kind == "prefix":
        mask = np.arange(S) <= S - 40
    else:
        mask = rng.random((B, S)) < 0.3
        mask[0, S // 8:S // 2] = False          # whole splits with no valid slot
        mask[-1] = False                         # a fully masked row
    out, skipped = _mma_emulation(q, k, v, mask)
    if kind == "holes":
        assert skipped > 0 and np.all(out[-1] == 0)
    rows = np.broadcast_to(mask.reshape(-1, S), (B, S))
    for b in np.flatnonzero(rows.any(axis=1)):   # the oracle takes one (S,) mask
        ref = np.asarray(jax_ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                 jnp.asarray(v[b:b + 1]), jnp.asarray(rows[b])))
        np.testing.assert_allclose(out[b:b + 1], ref, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 mask=jnp.asarray(mask), block=512))
    np.testing.assert_allclose(out, kern, rtol=1e-5, atol=1e-5)
