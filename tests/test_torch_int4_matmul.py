"""int4 quantisation and matmul: the port's codes and scales against the
JAX package's bit for bit, its plain int4 matmul against the JAX oracle
(``int4_matmul_ref``) and the JAX Pallas kernel in interpret mode.  The
CUDA kernel is held against the plain version on the card in
test_torch_cuda_kernels.py.

Tolerance: the plain matmul in f32 against the oracle and the Pallas
kernel, 1e-5 relative (sums in another order).  The wgmma path's and the
GEMV's order (bf16 x times bf16 codes summed in f32 per scale group or
per 32 k, then scaled) against both at 1e-5 relative to max |out| in f32,
and within one bf16 rounding (2^-8 relative) of the plain version's bf16
output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int4_matmul.int4_matmul import int4_matmul_pallas
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
    # int4 reaches the kernel and is charged as the reference charges it;
    # the port's int8 fused route multiplies a written bf16 copy, and is
    # charged that copy's write and read on top
    copy = 0 if bits == 4 else 2 * K * N * 2
    assert qt.nbytes_streamed == qj.nbytes_streamed + copy


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


QWEN_LAYER = [(3584, 3584), (3584, 512), (3584, 512), (3584, 3584),
              (3584, 18944), (3584, 18944), (18944, 3584)]   # wq wk wv wo gate up down


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("K,N,group", [(K, N, 128) for K, N in QWEN_LAYER[1:]]
                         + [(32, 16, 16), (3584, 512, 256)])
def test_split_plan_covers_k(M, K, N, group):
    """The GEMV's K slices (as the kernel cuts them: slice y owns scale
    groups [y G / splits, (y + 1) G / splits)) cover K once, stream the
    same packed bytes to within one scale group, all fit on 132 SMs at
    once (one resident wave), and leave every block's x and scale rows
    within its shared memory."""
    splits = ops.split_plan(K, N, 132, M, group)
    G = K // group
    assert 1 <= splits <= G
    bounds = [y * G // splits for y in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == G
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    tiles = -(-N // ops.GEMV_TILE)
    assert tiles * splits <= ops.GEMV_BLOCKS_PER_SM * 132 or splits == 1
    rows = max(sizes) * group // 2
    assert rows * M * 8 + max(sizes) * ops.GEMV_TILE * 4 <= ops.GEMV_SMEM


@pytest.mark.parametrize("M,dtype,path", [
    (1, torch.bfloat16, "gemv"), (4, torch.float32, "gemv"),
    (5, torch.bfloat16, "wgmma"), (2048, torch.bfloat16, "wgmma"),
    (5, torch.float32, "tiled"), (512, torch.float32, "tiled")])
def test_path_for(M, dtype, path):
    assert ops.path_for(M, dtype) == path


@pytest.mark.parametrize("group,N", [(8, 128), (64, 98)])
def test_wgmma_path_rejects_shapes_it_does_not_take(group, N):
    x = torch.zeros((8, 128), dtype=torch.bfloat16)
    packed = torch.zeros((64, N), dtype=torch.uint8)
    scales = torch.ones((128 // group, N))
    with pytest.raises(ValueError, match="wgmma"):
        ops._check(x, packed, scales, group)


@pytest.mark.parametrize("M,group,N", [(1, 8, 128), (4, 16, 24), (2, 2, 64)])
def test_gemv_rejects_shapes_it_does_not_take(M, group, N):
    x = torch.zeros((M, 128), dtype=torch.bfloat16)
    packed = torch.zeros((64, N), dtype=torch.uint8)
    scales = torch.ones((128 // group, N))
    with pytest.raises(ValueError, match="GEMV"):
        ops._check(x, packed, scales, group)


@pytest.mark.parametrize("M,K,N,group", [
    (64, 256, 128, 128), (70, 256, 96, 32), (130, 192, 300, 48),
    (1, 512, 128, 128), (4, 384, 96, 64), (1, 256, 64, 16), (4, 512, 48, 256)])
def test_scale_after_product_order(M, K, N, group):
    """The wgmma path's and the GEMV's arithmetic: x in bf16 times the
    exact bf16 codes, summed in f32 over a chunk of k (the wgmma path a
    scale group; the GEMV (M <= 4) a warp's 32 k of a band, or the group
    if smaller), then scaled per (group, column) and added, against the
    JAX Pallas kernel (interpret mode) and the plain version on the same
    bf16 inputs."""
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    packed = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8))
    scales = torch.from_numpy(
        (0.01 * 2.0 ** rng.integers(-3, 4, (K // group, N))).astype(np.float32))
    codes = unpack_int4_ref(packed).float()
    assert int(codes.min()) == -8 and int(codes.max()) == 7
    xf = x.float()
    chunk = min(group, 32) if M <= ops.GEMV_MAX_M else group
    order = sum(
        (xf[:, k:k + chunk] @ codes[k:k + chunk]) * scales[k // group]
        for k in range(0, K, chunk))
    tol = 1e-5 * float(order.abs().max())
    plain = int4_matmul_ref(xf, packed, scales, group)
    np.testing.assert_allclose(order.numpy(), plain.numpy(), rtol=0, atol=tol)
    pallas = np.asarray(int4_matmul_pallas(
        jnp.asarray(xf.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(scales.numpy()), group=group, bm=M, bn=N, bk=K,
        interpret=True))
    np.testing.assert_allclose(order.numpy(), pallas, rtol=0, atol=tol)
    plain_bf16 = int4_matmul_ref(x, packed, scales, group)
    assert plain_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(plain_bf16.float().numpy(), order.numpy(),
                               rtol=2.0 ** -8, atol=tol)
