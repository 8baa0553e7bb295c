"""The RMSNorm kernel's plain version (what the port runs for a CPU
tensor) against the JAX package's RMSNorm kernel (``repro.kernels.rmsnorm``,
the Pallas kernel in interpret mode on the CPU, as ``tests/test_kernels.py``
runs it) and against the model's ``common.rmsnorm`` for the
non-parametric variant, on the same numpy inputs.

Tolerances: f32 1e-5 (both sides compute in f32 and differ in the order
of the row sum); bf16 one bf16 spacing of the output (2^-7 relative),
as the f32 results round to bf16 on both sides and may straddle a
rounding boundary."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models.common import rmsnorm as jax_common_rmsnorm
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import common

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(jnp.bfloat16).astype(np.float32)
        w = w.astype(jnp.bfloat16).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [
    (1, 256),          # one decode row
    (300, 128),        # 300 rows: the Pallas wrapper pads to 512
    (2, 3, 64),        # leading dims flattened
    (7, 96),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(shape, dtype):
    x, w = _inputs(shape, dtype, seed=sum(shape))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x).astype(jd),
                                  jnp.asarray(w).astype(jd)).astype(jnp.float32))
    got = ops.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonparametric_matches_jax(dtype):
    x, _ = _inputs((4, 5, 64), dtype, seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_common_rmsnorm(jnp.asarray(x).astype(jd), None)
                      .astype(jnp.float32))
    got = ops.rmsnorm(torch.from_numpy(x).to(td), None)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("parametric", [True, False])
def test_model_norm_routes_cpu_tensors_to_the_plain_version(parametric):
    x, w = _inputs((3, 2, 64), "float32", seed=11)
    xt = torch.from_numpy(x)[:, -1:]             # a strided slice, as at decode
    wt = torch.from_numpy(w) if parametric else None
    before = ops.launches
    out = common.rmsnorm(xt, wt)
    assert torch.equal(out, rmsnorm_ref(xt, wt)) and ops.launches == before


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="no rmsnorm"):
        ops.rmsnorm(torch.zeros((2, 8), device="meta"), None)
