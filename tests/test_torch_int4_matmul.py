"""int4 quantisation and matmul: the port's codes and scales against the
JAX package's bit for bit, its plain int4 matmul against the JAX oracle
(``int4_matmul_ref``) and the JAX Pallas kernel in interpret mode.  The
CUDA kernel is held against the plain version on the card in
test_torch_cuda_kernels.py.

Tolerance: the plain matmul in f32 against the oracle and the Pallas
kernel, 1e-5 relative (sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int4_matmul.ops import int4_matmul as jax_kernel
from repro.kernels.int4_matmul.ref import int4_matmul_ref as jax_ref
from repro.quant import quantize as jax_quantize
from repro.quant import unpack_int4 as jax_unpack
from repro_torch.kernels.int4_matmul import ops
from repro_torch.kernels.int4_matmul.ref import int4_matmul_ref, unpack_int4_ref
from repro_torch.quant import dequantize, quantize, unpack_int4

SHAPES = [  # tests/test_kernels.py::TestInt4Matmul shapes
    (1, 128, 128, 128),
    (4, 256, 384, 128),
    (16, 64, 96, 64),
    (130, 512, 300, 128),
    (8, 128, 128, 32),
]


def _weights(K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    w[0, :4] = [0.7, -0.8, 0.05, -0.05]   # codes at 7, -8 and exact ties
    return w


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N,group", [(128, 96, 128), (256, 64, 32), (6, 8, 2)])
def test_quantize_bit_equal_to_jax(bits, K, N, group):
    w = _weights(K, N, K + N)
    qj = jax_quantize(jnp.asarray(w), bits, group)
    qt = quantize(torch.from_numpy(w), bits, group)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(qj.scales))
    assert (qt.k, qt.n, qt.group, qt.shape) == (qj.k, qj.n, qj.group, qj.shape)
    assert qt.nbytes_streamed == qj.nbytes_streamed


def test_quantize_stacked_and_unpack():
    w = np.stack([_weights(64, 32, s) for s in range(3)])
    qj = jax_quantize(jnp.asarray(w), 4, 32)
    qt = quantize(torch.from_numpy(w), 4, 32)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data))
    q = unpack_int4(qt.data)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_unpack(qj.data)))
    assert int(q.min()) >= -8 and int(q.max()) == 7
    np.testing.assert_array_equal(unpack_int4_ref(qt.data[0]).numpy(), q[0].numpy())
    np.testing.assert_allclose(dequantize(qt, torch.float32).numpy(),
                               np.asarray(jnp.asarray(w)), atol=0.1 / 7 * 4)


def test_every_nibble_code_unpacks_like_jax():
    """Symmetric quantisation never emits -8; raw bytes hit every code."""
    packed = np.arange(256, dtype=np.uint8).reshape(16, 16)
    ours = unpack_int4_ref(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_unpack(jnp.asarray(packed))))
    assert ours.min() == -8 and ours.max() == 7


@pytest.mark.parametrize("M,K,N,group", SHAPES)
def test_plain_matches_jax_ref_and_kernel(M, K, N, group):
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qt = quantize(torch.from_numpy(_weights(K, N, M)), 4, group)
    out = int4_matmul_ref(torch.from_numpy(x), qt.data, qt.scales, qt.group).numpy()
    data, scales = jnp.asarray(qt.data.numpy()), jnp.asarray(qt.scales.numpy())
    ref = np.asarray(jax_ref(jnp.asarray(x), data, scales, qt.group))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jax_kernel(jnp.asarray(x), data, scales, group=qt.group))
    np.testing.assert_allclose(out, kern, rtol=1e-5, atol=1e-4)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    x = torch.randn(3, 256, generator=torch.Generator().manual_seed(0))
    qt = quantize(torch.from_numpy(_weights(256, 64, 0)), 4, 128)
    before = ops.launches
    torch.testing.assert_close(ops.int4_matmul(x, qt.data, qt.scales, group=128),
                               int4_matmul_ref(x, qt.data, qt.scales, 128))
    assert ops.launches == before


def test_split_plan_covers_k():
    for K, N in [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (32, 8)]:
        splits, k_split = ops.split_plan(K, N, 132)
        assert k_split % ops.GEMV_ROWS == 0
        assert (splits - 1) * k_split < K <= splits * k_split
