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
