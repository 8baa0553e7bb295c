"""The port's dense model and engine against the JAX package, bridged
through ``from_jax_params`` so both run the same weights, on the CPU in
f32, for every dense config ``.reduced()``.

Biases and norm weights are perturbed with numpy noise before bridging
(JAX init sets them to zeros and ones), so their handling is exercised.

Tolerances: f32 logits agree to 1e-5 (O(1) values, measured ~1e-6; the two
frameworks sum matmuls in different orders).  Greedy token streams must
be identical.  On the int4_fused path the JAX package on the CPU
multiplies by a bf16 dequantisation of the weights
(``repro/quant/paths.py``: ``x @ dequantize(w, bf16)``) while the port's
plain int4 matmul scales in f32, so there the logits agree to 2e-2
absolute and tokens are not compared."""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro_torch.bridge import from_jax_params, to_tensor
from repro_torch.configs import get_config
from repro_torch.models.attention import DECODE_BACKENDS
from repro_torch.models.model import Model
from repro_torch.quant import QuantizedTensor, quantize_tree
from repro_torch.serving import DecodeEngine

DENSE = [n for n in list_configs() if jax_get_config(n).family == "dense"]
B, PROMPT, N_DECODE, MAX_LEN = 2, 12, 8, 32
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def _perturb(p, rng):
    """Noise on biases and norm weights (numpy tree, returned anew)."""
    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if node is None:
            return None
        if name in ("bq", "bk", "bv"):
            return node + 0.1 * rng.standard_normal(node.shape).astype(node.dtype)
        if name in ("norm1", "norm2", "final_norm"):
            return node + 0.1 * rng.standard_normal(node.shape).astype(node.dtype)
        return node
    return visit(p)


def _jax_tree(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


@functools.lru_cache(maxsize=None)
def _case(name, window=None, prompt=PROMPT, quant="bf16"):
    """JAX side of one config: numpy params, tokens, prefill + teacher-
    forced decode logits, greedy streamed and fused tokens."""
    jcfg = jax_get_config(name).reduced().replace(dtype="float32")
    if window:
        jcfg = jcfg.replace(sliding_window=window)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{window}".encode()))
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    np_params = _perturb(jax.tree_util.tree_map(np.asarray, params), rng)
    tokens = rng.integers(0, jcfg.vocab_size, (B, prompt + N_DECODE)).astype(np.int32)
    eng = JaxEngine(JaxModel(jcfg), _jax_tree(np_params), quant_path=quant)
    logits, cache = eng.prefill({"tokens": jnp.asarray(tokens[:, :prompt])}, MAX_LEN)
    steps = [np.asarray(logits)]
    for i in range(N_DECODE):
        tok = jnp.asarray(tokens[:, prompt + i:prompt + i + 1])
        logits, cache = eng._step(eng.params, cache, tok)
        steps.append(np.asarray(logits))
    streams = None
    if quant == "bf16" and window is None:
        batch = {"tokens": jnp.asarray(tokens[:, :prompt])}
        streams = (np.asarray(eng.generate_streamed(batch, max_len=MAX_LEN,
                                                    n_new=N_DECODE).tokens),
                   np.asarray(eng.generate_fused(batch, max_len=MAX_LEN,
                                                 n_new=N_DECODE).tokens))
    q_np = None
    if quant != "bf16":
        q_np = jax.tree_util.tree_map(np.asarray, eng.params)
    return np_params, q_np, tokens, steps, streams


def _port_cfg(name, window=None):
    cfg = get_config(name).reduced().replace(dtype="float32")
    return cfg.replace(sliding_window=window) if window else cfg


def _run_port(model, params, tokens, prompt):
    cache = model.init_cache(B, MAX_LEN)
    toks = torch.from_numpy(tokens)
    logits, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, cache)
    out = [logits]
    for i in range(N_DECODE):
        logits, cache = model.decode_step(params, cache, toks[:, prompt + i:prompt + i + 1])
        out.append(logits)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_logits_match_jax(name, backend):
    np_params, _, tokens, ref, _ = _case(name)
    cfg = _port_cfg(name)
    model = Model(cfg, decode_backend=backend, device=CPU)
    got = _run_port(model, from_jax_params(np_params, cfg, CPU), tokens, PROMPT)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("name", DENSE)
def test_greedy_streams_match_jax(name):
    np_params, _, tokens, _, (streamed, fused) = _case(name)
    cfg = _port_cfg(name)
    eng = DecodeEngine(Model(cfg, decode_backend="cuda", device=CPU),
                       from_jax_params(np_params, cfg, CPU))
    batch = {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
    s = eng.generate_streamed(batch, max_len=MAX_LEN, n_new=N_DECODE, timed=True)
    f = eng.generate_fused(batch, max_len=MAX_LEN, n_new=N_DECODE)
    np.testing.assert_array_equal(s.tokens.numpy(), streamed)
    np.testing.assert_array_equal(f.tokens.numpy(), fused)
    assert len(s.step_times_s) == N_DECODE - 1


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
def test_ring_cache_matches_jax(backend):
    """Sliding window 16 over a 32-slot request: the cache is a 16-slot
    ring, the 20-token prompt wraps it at prefill and decode wraps again."""
    name, window, prompt = "qwen2.5-3b", 16, 20
    np_params, _, tokens, ref, _ = _case(name, window, prompt)
    cfg = _port_cfg(name, window)
    model = Model(cfg, decode_backend=backend, device=CPU)
    assert model.init_cache(B, MAX_LEN)["k"].shape[2] == window
    got = _run_port(model, from_jax_params(np_params, cfg, CPU), tokens, prompt)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("name", ["qwen2.5-7b", "olmo-1b"])
def test_int4_fused_matches_jax(name):
    np_params, q_np, tokens, ref, _ = _case(name, quant="int4_fused")
    cfg = _port_cfg(name)
    bridged = from_jax_params(q_np, cfg, CPU)
    ours = quantize_tree(from_jax_params(np_params, cfg, CPU), "int4_fused")
    for a, b in zip(bridged["blocks"], ours["blocks"]):
        for sub in ("attn", "mlp"):
            for key, qa in a[sub].items():
                qb = b[sub][key]
                assert isinstance(qa, QuantizedTensor) == isinstance(qb, QuantizedTensor)
                if isinstance(qa, QuantizedTensor):
                    assert (qa.bits, qa.path, qa.group) == (qb.bits, qb.path, qb.group)
                    assert torch.equal(qa.data, qb.data) and torch.equal(qa.scales, qb.scales)
    model = Model(cfg, decode_backend="cuda", device=CPU)
    got = _run_port(model, bridged, tokens, PROMPT)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2, err_msg=f"step {i}")


def test_cache_is_updated_in_place():
    name = "qwen2.5-3b"
    np_params, _, tokens, _, _ = _case(name)
    cfg = _port_cfg(name)
    model = Model(cfg, device=CPU)
    params = from_jax_params(np_params, cfg, CPU)
    cache = model.init_cache(B, MAX_LEN)
    k, pos = cache["k"], cache["pos"]
    toks = torch.from_numpy(tokens)
    _, out = model.prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
    _, out = model.decode_step(params, out, toks[:, PROMPT:PROMPT + 1])
    assert out is cache and out["k"] is k and out["pos"] is pos
    assert int(pos) == PROMPT + 1
    assert bool(k[:, :, PROMPT].abs().sum() > 0) and bool(k[:, :, PROMPT + 1:].eq(0).all())


def test_unported_paths_raise():
    cfg = _port_cfg("qwen2.5-3b")
    model = Model(cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="paged"):
        model.init_cache(2, 16, paged=True)
    with pytest.raises(NotImplementedError, match="int8"):
        model.init_cache(2, 16, kv_quant="int8")
    with pytest.raises(NotImplementedError, match="slice"):
        model.decode_steps(None, None, None, steps_left=torch.ones(2), horizon=2)
    with pytest.raises(NotImplementedError, match="dispatch"):
        model.step_program(None, None)
    with pytest.raises(NotImplementedError, match="family"):
        Model(get_config("mamba2-2.7b").reduced(), device=CPU)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_mask_matches_jax(ring):
    from repro.models.attention import decode_mask as jax_mask
    from repro_torch.models.attention import decode_mask
    for pos in (0, 5, 15, 16, 23):
        got = decode_mask(torch.tensor(pos, dtype=torch.int32), 16, ring=ring)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_mask(jnp.int32(pos), 16, ring=ring)))
    vec = np.array([0, 7, 16, 30], np.int32)
    got = decode_mask(torch.from_numpy(vec), 16, ring=ring)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_mask(jnp.asarray(vec), 16, ring=ring)))


@pytest.mark.parametrize("per_slot,active", [(False, False), (True, False),
                                             (True, True)])
def test_kv_write_in_place_matches_jax(per_slot, active):
    from repro.models.attention import _kv_write as jax_write
    from repro_torch.models.attention import _kv_write
    rng = np.random.default_rng(5)
    dst = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([1, 6, 3], np.int32) if per_slot else np.int32(4)
    act = np.array([True, False, True]) if active else None
    want = np.asarray(jax_write(jnp.asarray(dst), jnp.asarray(new), jnp.asarray(pos),
                                None if act is None else jnp.asarray(act)))
    t = torch.from_numpy(dst.copy())
    out = _kv_write(t, torch.from_numpy(new), torch.from_numpy(np.asarray(pos)),
                    None if act is None else torch.from_numpy(act))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), want)


def test_temperature_top_k_sampling_draws_from_the_top_k():
    from repro_torch.serving.sampling import sample
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    a = sample(logits, torch.Generator().manual_seed(1), temperature=0.8, top_k=3)
    b = sample(logits, torch.Generator().manual_seed(1), temperature=0.8, top_k=3)
    assert a.dtype == torch.int32 and a.shape == (4,) and torch.equal(a, b)
    idx = torch.topk(logits, 3).indices
    assert all(int(a[i]) in idx[i].tolist() for i in range(4))
    assert torch.equal(sample(logits), logits.argmax(-1).to(torch.int32))


def test_attention_full_chunked_matches_jax(monkeypatch):
    """The q-chunked branch (above CHUNKED_ATTN_THRESHOLD), forced at a
    small size on both sides, against the JAX package's scan version."""
    from repro.models import attention as jax_attn
    from repro.models.common import apply_rope as jax_rope
    from repro.models.common import make_angle_fn as jax_angles
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_rope, make_angle_fn
    name, S = "qwen2.5-3b", 16
    np_params, _, _, _, _ = _case(name)
    cfg = _port_cfg(name).replace(sliding_window=6)
    jcfg = jax_get_config(name).reduced().replace(dtype="float32", sliding_window=6)
    p = {k: v[0] for k, v in np_params["blocks"]["attn"].items()}
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    monkeypatch.setattr(attn, "CHUNKED_ATTN_THRESHOLD", 8)
    monkeypatch.setattr(attn, "CHUNK_Q", 4)
    out, (k, _) = attn.attention_full({n: to_tensor(v, CPU) for n, v in p.items()},
                                      torch.from_numpy(x),
                                      make_angle_fn(cfg)(torch.from_numpy(pos.copy())),
                                      cfg, apply_rope)
    monkeypatch.setattr(jax_attn, "CHUNKED_ATTN_THRESHOLD", 8)
    monkeypatch.setattr(jax_attn, "CHUNK_Q", 4)
    ref, (kr, _) = jax_attn.attention_full(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x),
        jax_angles(jcfg)(jnp.asarray(pos)), jcfg, jax_rope)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(kr), **TOL)
