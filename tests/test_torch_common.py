"""The port's model primitives (repro_torch.models.common) against the
JAX package's, on the same numpy inputs, in f32 on the CPU.

Tolerance: 1e-5 absolute on O(1) values — both sides compute in f32 and
differ only in the order of their sums and in last-ulp transcendentals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.models import common as tc

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("parametric", [True, False])
def test_rmsnorm(parametric):
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32) if parametric else None
    ref = jc.rmsnorm(jnp.asarray(x), None if w is None else jnp.asarray(w))
    out = tc.rmsnorm(torch.from_numpy(x), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = _rng(1)
    hd = 32
    x = rng.standard_normal((2, 7, 4, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None] + 100, (2, 7)).astype(np.int32)
    ref = jc.apply_rope(jnp.asarray(x),
                        jc._rope_angles(jnp.asarray(pos), jc.rope_inv_freq(hd, theta)))
    out = tc.apply_rope(torch.from_numpy(x),
                        tc._rope_angles(torch.from_numpy(pos), tc.rope_inv_freq(hd, theta)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_mrope_angles_and_text_reduction():
    rng = _rng(2)
    hd, sections = 32, (4, 6, 6)
    pos = rng.integers(0, 50, (2, 5, 3)).astype(np.int32)
    ref = jc.mrope_angles(jnp.asarray(pos), jc.rope_inv_freq(hd, 1e6), sections)
    out = tc.mrope_angles(torch.from_numpy(pos), tc.rope_inv_freq(hd, 1e6), sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # text-only stream through make_angle_fn: t == h == w reduces to RoPE
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-vl-2b").reduced()
    text = torch.arange(9)[None]
    a = tc.make_angle_fn(cfg)(text)
    b = tc._rope_angles(text, tc.rope_inv_freq(cfg.head_dim, cfg.rope_theta))
    torch.testing.assert_close(a, b)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = _rng(3)
    d, f = 32, 64
    p = {"up": rng.standard_normal((d, f)), "down": rng.standard_normal((f, d))}
    if gated:
        p["gate"] = rng.standard_normal((d, f))
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    ref = jc.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), gated)
    out = tc.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), gated)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_init_distributions_on_the_generator_device():
    gen = torch.Generator(device="cpu").manual_seed(0)
    w = tc.dense_init(gen, 256, 512, torch.bfloat16)
    e = tc.embed_init(gen, 1000, 64, torch.float32)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(float(w.float().std()) - 1 / 16) < 5e-3
    assert abs(float(e.std()) - 0.02) < 1e-3
