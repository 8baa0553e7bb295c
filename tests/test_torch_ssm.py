"""The port's Mamba2 blocks and its ssm (mamba2-2.7b) and hybrid
(zamba2-1.2b) models against the JAX package, on the CPU in f32, with
the same weights (the reference's ``init``, bridged by
``from_jax_params``) and the same numpy inputs.

Norm weights, ``D`` and the conv bias are perturbed with numpy noise
before bridging (the reference initialises them to ones and zeros), so
their handling is exercised.

Tolerance: 1e-5 on f32 values of order one (both sides compute in f32;
the chunked scan's contractions are split into two-operand steps here and
summed in another order).  Greedy token streams must be identical."""
import functools
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as jax_mamba2
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro_torch.bridge import from_jax_params, to_tensor
from repro_torch.configs import get_config
from repro_torch.models import mamba2
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
B, PROMPT, N_DECODE, MAX_LEN, CHUNK = 2, 16, 8, 32, 8
ROOT = Path(__file__).resolve().parents[1]


def _perturb(p, rng):
    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if name in ("norm1", "norm2", "final_norm", "gate_norm", "D", "conv_b"):
            return node + 0.1 * rng.standard_normal(node.shape).astype(node.dtype)
        return node
    return visit(p)


def _jax_cfg(name, window=None):
    cfg = jax_get_config(name).reduced().replace(dtype="float32")
    return cfg.replace(sliding_window=window) if window else cfg


def _port_cfg(name, window=None):
    cfg = get_config(name).reduced().replace(dtype="float32")
    return cfg.replace(sliding_window=window) if window else cfg


@functools.lru_cache(maxsize=None)
def _case(name, window=None, prompt=PROMPT, max_len=MAX_LEN, batch=B):
    """JAX side: numpy params, tokens, prefill + teacher-forced decode
    logits, final state, greedy streamed and fused tokens."""
    jcfg = _jax_cfg(name, window)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{window}/{prompt}".encode()))
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    np_params = _perturb(jax.tree_util.tree_map(np.asarray, params), rng)
    tokens = rng.integers(0, jcfg.vocab_size,
                          (batch, prompt + N_DECODE)).astype(np.int32)
    jm = JaxModel(jcfg, ssd_chunk=CHUNK)
    eng = JaxEngine(jm, jax.tree_util.tree_map(jnp.asarray, np_params))
    logits, cache = eng.prefill({"tokens": jnp.asarray(tokens[:, :prompt])},
                                max_len)
    steps = [np.asarray(logits)]
    for i in range(N_DECODE):
        tok = jnp.asarray(tokens[:, prompt + i:prompt + i + 1])
        logits, cache = eng._step(eng.params, cache, tok)
        steps.append(np.asarray(logits))
    state = {k: np.asarray(v) for k, v in cache.items()}
    batch_in = {"tokens": jnp.asarray(tokens[:, :prompt])}
    streams = (np.asarray(eng.generate_streamed(batch_in, max_len=max_len,
                                                n_new=N_DECODE).tokens),
               np.asarray(eng.generate_fused(batch_in, max_len=max_len,
                                             n_new=N_DECODE).tokens))
    return np_params, tokens, steps, state, streams


def _port(name, window=None):
    cfg = _port_cfg(name, window)
    return Model(cfg, decode_backend="cuda", ssd_chunk=CHUNK, device=CPU), cfg


def _run_port(model, params, tokens, prompt, max_len=MAX_LEN):
    cache = model.init_cache(tokens.shape[0], max_len)
    toks = torch.from_numpy(tokens)
    logits, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, cache)
    out = [logits.numpy()]
    for i in range(N_DECODE):
        logits, cache = model.decode_step(params, cache,
                                          toks[:, prompt + i:prompt + i + 1])
        out.append(logits.numpy())
    return out, cache


# ---------------------------------------------------------------- blocks
def _block_case(seed, S, G=1):
    jcfg = _jax_cfg("mamba2-2.7b").replace(ssm_groups=G)
    rng = np.random.default_rng(seed)
    p = jax_mamba2.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = _perturb(jax.tree_util.tree_map(np.asarray, p), rng)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    cfg = _port_cfg("mamba2-2.7b").replace(ssm_groups=G)
    return jcfg, cfg, p, {k: to_tensor(v, CPU) for k, v in p.items()}, x


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("G", [1, 2])
def test_mamba_forward_matches_jax(chunk, G):
    """S = 32: chunks 8 and 16 run the inter-chunk recurrence over 4 and
    2 chunks, chunk 32 is one chunk."""
    jcfg, cfg, p_np, p, x = _block_case(1, 32, G)
    y, h, conv = mamba2.mamba_forward(p, torch.from_numpy(x), cfg, chunk=chunk)
    jy, jh, jconv = jax_mamba2.mamba_forward(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x), jcfg,
        chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)


def test_ssd_chunked_rejects_a_ragged_sequence():
    x = torch.zeros((1, 12, 2, 4))
    with pytest.raises(ValueError, match="not divisible"):
        mamba2.ssd_chunked(x, torch.zeros((1, 12, 2)), torch.zeros(2),
                           torch.zeros((1, 12, 1, 4)), torch.zeros((1, 12, 1, 4)),
                           torch.zeros((1, 2, 4, 4)), chunk=8)


@pytest.mark.parametrize("G", [1, 2])
def test_mamba_decode_step_matches_jax_in_place(G):
    jcfg, cfg, p_np, p, x = _block_case(2, 1, G)
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)).astype(np.float32)
    c0 = rng.standard_normal((2, cfg.ssm_conv - 1,
                              cfg.conv_channels)).astype(np.float32)
    h, conv = torch.from_numpy(h0.copy()), torch.from_numpy(c0.copy())
    y, h_out, conv_out = mamba2.mamba_decode_step(p, torch.from_numpy(x), h,
                                                  conv, cfg)
    assert h_out is h and conv_out is conv
    jy, jh, jconv = jax_mamba2.mamba_decode_step(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x),
        jnp.asarray(h0), jnp.asarray(c0), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_logits_match_jax(name):
    np_params, tokens, ref, state, _ = _case(name)
    model, cfg = _port(name)
    got, cache = _run_port(model, from_jax_params(np_params, cfg, CPU),
                           tokens, PROMPT)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i}")
    for key in state:
        np.testing.assert_allclose(cache[key].numpy(), state[key], **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_streams_match_jax(name):
    np_params, tokens, _, _, (streamed, fused) = _case(name)
    model, cfg = _port(name)
    eng = DecodeEngine(model, from_jax_params(np_params, cfg, CPU))
    batch = {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
    s = eng.generate_streamed(batch, max_len=MAX_LEN, n_new=N_DECODE, timed=True)
    f = eng.generate_fused(batch, max_len=MAX_LEN, n_new=N_DECODE)
    np.testing.assert_array_equal(s.tokens.numpy(), streamed)
    np.testing.assert_array_equal(f.tokens.numpy(), fused)
    np.testing.assert_array_equal(f.tokens.numpy(), s.tokens.numpy())
    assert len(s.step_times_s) == N_DECODE - 1


@pytest.mark.parametrize("prompt", [40, 80])
def test_sliding_window_ring_cache_matches_jax(prompt):
    """zamba2 reduced: window 64, ``init_cache(1, 128)`` makes a 64-slot
    ring.  A 40-token prompt wraps it during decode only after 24 more
    steps (not here); an 80-token prompt wraps it at prefill."""
    name, window, max_len = "zamba2-1.2b", 64, 128
    np_params, tokens, ref, state, _ = _case(name, window, prompt, max_len, 1)
    model, cfg = _port(name, window)
    assert cfg.sliding_window == 64
    assert model.init_cache(1, max_len)["k"].shape[2] == 64
    got, cache = _run_port(model, from_jax_params(np_params, cfg, CPU), tokens,
                           prompt, max_len)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i}")
    np.testing.assert_allclose(cache["k"].numpy(), state["k"], **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_unsupported_caches_raise(name):
    model, cfg = _port(name)
    for kw in (dict(slotted=True), dict(paged=True),
               dict(kv_dtype=torch.int8)):
        with pytest.raises(NotImplementedError):
            model.init_cache(2, 16, **kw)
    cache = model.init_cache(2, 16)
    with pytest.raises(NotImplementedError, match="attention families"):
        model.prefill_into_slot(None, {"tokens": torch.zeros((1, 4))}, cache, 0)
    with pytest.raises(NotImplementedError, match="active-lane"):
        model.decode_step(None, cache, torch.zeros((2, 1), dtype=torch.int32),
                          active=torch.ones(2, dtype=torch.bool))


def test_state_cache_layout():
    model, cfg = _port("zamba2-1.2b")
    cache = model.init_cache(3, 20)
    L, n_apps = cfg.n_layers, -(-cfg.n_layers // cfg.attn_every)
    assert cache["h"].shape == (L, 3, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state)
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].shape == (L, 3, cfg.ssm_conv - 1, cfg.conv_channels)
    assert cache["k"].shape == (n_apps, 3, 20, cfg.n_kv_heads, cfg.head_dim)
    assert cache["pos"].shape == ()
    assert set(_port("mamba2-2.7b")[0].init_cache(1, 8)) == {"h", "conv", "pos"}


@pytest.mark.parametrize("name,extra", [
    ("mamba2-2.7b", []), ("zamba2-1.2b", ["--mode", "fused"])])
def test_serve_cli_cpu_smoke(name, extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", name,
           "--reduced", "--device", "cpu", "--prompt-len", "16",
           "--new-tokens", "5", "--timed"]
    out = subprocess.run(cmd + extra, env=env, check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert "generated (1, 5) tokens on cpu" in out and "first tokens:" in out
    if not extra:
        assert "p50 step" in out and "analytic floor" in out
    bad = subprocess.run(cmd + ["--paged"], env=env, timeout=120,
                         capture_output=True, text=True)
    assert bad.returncode == 2 and "attention families" in bad.stderr
