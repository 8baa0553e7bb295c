"""Int8 KV quantisation in the port against the JAX package: the codes
(bit-equal) and scales (within 1e-7 relative) of ``quant/kv.py``, and
prefill + decode logits of a reduced qwen2.5-3b in f32 over a contiguous
int8 cache, per decode backend (``sdpa`` folds the scales into scores
and probabilities; the others read a dequantised view; ``cuda`` is the
decode-attention kernel's plain version on the CPU).  Logits agree to
1e-5 (O(1) values; the frameworks sum in different orders)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.quant import kv as jax_kv
from repro.serving import DecodeEngine as JaxEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models.attention import DECODE_BACKENDS
from repro_torch.models.model import Model
from repro_torch.quant import kv

NAME, B, PROMPT, N_DECODE, MAX_LEN = "qwen2.5-3b", 2, 10, 4, 20


@pytest.mark.parametrize("shape", [(3, 5, 2, 32), (1, 7, 4, 128), (4, 16)])
def test_codes_bit_equal_and_scales_match(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
    x[0, 0] = 0.0                        # an all-zero row: codes 0, scale 1e-12
    codes, scales = kv.quantize_kv_write(torch.from_numpy(x))
    jc, js = jax_kv.quantize_kv_write(jnp.asarray(x))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert (codes.numpy()[0, 0] == 0).all()
    back = kv.dequantize_kv(codes, scales, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_kv.dequantize_kv(
        jc, js, jnp.float32)))


@functools.lru_cache(maxsize=None)
def _reference():
    jcfg = jax_get_config(NAME).reduced().replace(dtype="float32")
    params = JaxModel(jcfg).init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, PROMPT + N_DECODE)).astype(np.int32)
    eng = JaxEngine(JaxModel(jcfg), params, kv_dtype=jnp.int8)
    logits, cache = eng.prefill({"tokens": jnp.asarray(tokens[:, :PROMPT])},
                                MAX_LEN)
    steps = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = eng._step(eng.params, cache,
                                  jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]))
        steps.append(np.asarray(logits))
    return jax.tree_util.tree_map(np.asarray, params), tokens, steps


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
def test_int8_contiguous_decode_matches_jax(backend):
    np_params, tokens, ref = _reference()
    cfg = get_config(NAME).reduced().replace(dtype="float32")
    model = Model(cfg, decode_backend=backend, device="cpu")
    params = from_jax_params(np_params, cfg, "cpu")
    cache = model.init_cache(B, MAX_LEN, kv_dtype=torch.int8)
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].shape == cache["k"].shape[:-1]
    toks = torch.from_numpy(tokens)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
        got = [logits.numpy()]
        for i in range(N_DECODE):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, PROMPT + i:PROMPT + i + 1])
            got.append(logits.numpy())
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=f"step {i}")
