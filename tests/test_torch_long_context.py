"""The port's long-sequence paths against the JAX package, on the CPU in
f32 at reduced size: what the paper's decode matrix (ctx 2048-16384)
runs on the card.

- the q-block-chunked prefill (``attention_full`` above
  ``CHUNKED_ATTN_THRESHOLD``), through the engine's streamed and fused
  loops of mistral-7b-v0.3 and llama-3.1-8b, with the threshold and
  ``CHUNK_Q`` forced low on both sides (the card's matrix takes this
  branch at 16384 tokens);
- zamba2-1.2b's sliding-window ring through the engine, with a prompt
  that wraps its 64-slot window at prefill (the card's matrix wraps the
  4096-slot window at ctx 8192);
- kernel 1's split plan at S 16384 and 16417 (pure Python: every slot
  in exactly one split), and the row-scaled tolerance of the card's
  long-S kernel-1 tests against an output that lost one split or one
  window of slots (the plain version standing in for the kernel);
- the floors of the matrix's cells, the port's copy against the
  reference's and the paper's Table 9.

Tolerance: 1e-5 on f32 logits, as tests/test_torch_model.py; greedy
tokens identical.  About 20 s on one worker."""
import contextlib
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import floor as jax_floor
from repro.core import hardware as jax_hardware
from repro.models import attention as jax_attn
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.floor import floor_cell
from repro_torch.core.hardware import GPU_H100
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import attention as attn
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine
from test_torch_cuda_kernels import _close_rows

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
DENSE = ["mistral-7b-v0.3", "llama-3.1-8b"]
PROMPT, N_NEW, MAX_LEN = 16, 8, 32
THRESHOLD, CHUNK_Q = 8, 4           # a 16-token prompt: 4 q blocks
ZAMBA, WINDOW, ZAMBA_MAX_LEN, SSD_CHUNK = "zamba2-1.2b", 64, 160, 8
MATRIX = [(a, c) for a in ("qwen2.5-7b",) + tuple(DENSE)
          for c in (2048, 4096, 8192, 16384)] + [(ZAMBA, 8192)]


@contextlib.contextmanager
def _chunked():
    """Both packages' chunk knobs forced low, restored after."""
    saved = [(m, m.CHUNKED_ATTN_THRESHOLD, m.CHUNK_Q) for m in (attn, jax_attn)]
    try:
        for m, _, _ in saved:
            m.configure(threshold=THRESHOLD, chunk_q=CHUNK_Q)
        yield
    finally:
        for m, t, q in saved:
            m.configure(threshold=t, chunk_q=q)


def _jax_cfg(name, window=None):
    cfg = jax_get_config(name).reduced().replace(dtype="float32")
    return cfg.replace(sliding_window=window) if window else cfg


def _port_cfg(name, window=None):
    cfg = get_config(name).reduced().replace(dtype="float32")
    return cfg.replace(sliding_window=window) if window else cfg


@functools.lru_cache(maxsize=None)
def _jax_case(name, prompt, window=None, max_len=MAX_LEN):
    """JAX side of one config with the chunk knobs forced low: numpy
    params, tokens, greedy streamed and fused tokens, prefill and
    teacher-forced decode logits (the streamed tokens fed back)."""
    jcfg = _jax_cfg(name, window)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{prompt}/{window}".encode()))
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tokens = rng.integers(0, jcfg.vocab_size, (1, prompt)).astype(np.int32)
    with _chunked():
        eng = JaxEngine(JaxModel(jcfg, ssd_chunk=SSD_CHUNK),
                        jax.tree_util.tree_map(jnp.asarray, np_params))
        batch = {"tokens": jnp.asarray(tokens)}
        streamed = np.asarray(eng.generate_streamed(batch, max_len=max_len,
                                                    n_new=N_NEW).tokens)
        fused = np.asarray(eng.generate_fused(batch, max_len=max_len, n_new=N_NEW).tokens)
        logits, cache = eng.prefill(batch, max_len)
        steps = [np.asarray(logits)]
        for i in range(N_NEW - 1):
            logits, cache = eng._step(eng.params, cache, jnp.asarray(streamed[:, i:i + 1]))
            steps.append(np.asarray(logits))
    return np_params, tokens, streamed, fused, steps


def _port_engine(name, np_params, window=None):
    cfg = _port_cfg(name, window)
    model = Model(cfg, decode_backend="cuda", ssd_chunk=SSD_CHUNK, device=CPU)
    return DecodeEngine(model, from_jax_params(np_params, cfg, CPU)), model


@pytest.mark.parametrize("name", DENSE)
def test_chunked_prefill_streams_match_jax(name):
    """The engine's streamed and fused loops over a prompt whose prefill
    runs q-block-chunked on both sides: greedy tokens identical to the
    JAX engine's, streamed = fused."""
    np_params, tokens, streamed, fused, _ = _jax_case(name, PROMPT)
    eng, _ = _port_engine(name, np_params)
    batch = {"tokens": torch.from_numpy(tokens)}
    with _chunked():
        s = eng.generate_streamed(batch, max_len=MAX_LEN, n_new=N_NEW, timed=True)
        f = eng.generate_fused(batch, max_len=MAX_LEN, n_new=N_NEW)
    np.testing.assert_array_equal(s.tokens.numpy(), streamed)
    np.testing.assert_array_equal(f.tokens.numpy(), fused)
    np.testing.assert_array_equal(f.tokens.numpy(), s.tokens.numpy())


@pytest.mark.parametrize("name", DENSE)
def test_chunked_prefill_logits_match_jax(name, monkeypatch):
    """Prefill (q-block-chunked: every score block is CHUNK_Q queries
    wide) and the teacher-forced decode steps after it: logits within
    1e-5 of the JAX package's, the last step's included."""
    np_params, tokens, streamed, _, ref = _jax_case(name, PROMPT)
    eng, model = _port_engine(name, np_params)
    widths = []
    real = attn._gqa_scores

    def spy(q, k, cfg):
        widths.append(q.shape[1])
        return real(q, k, cfg)
    monkeypatch.setattr(attn, "_gqa_scores", spy)
    with _chunked(), torch.inference_mode():
        logits, cache = eng.prefill({"tokens": torch.from_numpy(tokens)}, MAX_LEN)
        got = [logits.numpy()]
        for i in range(N_NEW - 1):
            logits, cache = model.decode_step(eng.params, cache,
                                              torch.from_numpy(streamed[:, i:i + 1].copy()))
            got.append(logits.numpy())
    assert widths == [CHUNK_Q] * (PROMPT // CHUNK_Q) * model.cfg.n_layers
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("prompt", [80, 144])
def test_zamba2_ring_through_the_engine_matches_jax(prompt):
    """zamba2-1.2b reduced with a 64-slot window: the prompt wraps the ring
    at prefill (once or twice) and decode keeps writing round it; the
    engine's streamed and fused tokens equal the JAX engine's, and the
    last decode step's logits agree."""
    np_params, tokens, streamed, fused, ref = _jax_case(ZAMBA, prompt, WINDOW,
                                                        ZAMBA_MAX_LEN)
    eng, model = _port_engine(ZAMBA, np_params, WINDOW)
    batch = {"tokens": torch.from_numpy(tokens)}
    s = eng.generate_streamed(batch, max_len=ZAMBA_MAX_LEN, n_new=N_NEW)
    f = eng.generate_fused(batch, max_len=ZAMBA_MAX_LEN, n_new=N_NEW)
    np.testing.assert_array_equal(s.tokens.numpy(), streamed)
    np.testing.assert_array_equal(f.tokens.numpy(), fused)
    np.testing.assert_array_equal(f.tokens.numpy(), s.tokens.numpy())
    with torch.inference_mode():
        logits, cache = eng.prefill(batch, ZAMBA_MAX_LEN)
        assert cache["k"].shape[2] == WINDOW
        for i in range(N_NEW - 1):
            logits, cache = model.decode_step(eng.params, cache,
                                              torch.from_numpy(streamed[:, i:i + 1].copy()))
    np.testing.assert_allclose(logits.numpy(), ref[-1], **TOL)


def test_zamba2_full_width_ring_at_ctx_8192():
    """At full width the matrix's zamba2 cell (prompt 8192, 33 more
    slots) gets a 4096-slot ring, as the reference's cache has."""
    model = Model(get_config(ZAMBA), device="meta")
    cache = model.init_cache(1, 8192 + 33)
    want = jax.eval_shape(lambda: JaxModel(jax_get_config(ZAMBA)).init_cache(1, 8192 + 33))
    assert cache["k"].shape[2] == 4096
    assert tuple(cache["k"].shape) == tuple(want["k"].shape)


@pytest.mark.parametrize("B,Hkv,S,splits", [
    (1, 4, 16384, 33), (1, 4, 16417, 33), (1, 8, 16384, 16), (1, 8, 16417, 16),
    (17, 8, 16384, 1)])
def test_mma_split_plan_covers_every_slot_once(B, Hkv, S, splits):
    """Kernel 1's mma path at the matrix's long shapes on an H100 (132
    SMs): the plan's split count, and ``split_range`` gives every slot of
    S to exactly one split, in order, each split within 16 slots of the
    others; one split (17 x 8 pairs) walks all S slots, past the 4096
    slots of mask bits a block holds at once."""
    n = da_ops.mma_split_plan(B, Hkv, S, 132)
    assert n == splits
    ranges = [da_ops.split_range(S, i, n) for i in range(n)]
    covered = np.zeros(S, np.int32)
    for s0, s1 in ranges:
        covered[s0:s1] += 1
    assert (covered == 1).all()
    assert [r[0] for r in ranges] == sorted(r[0] for r in ranges)
    lens = [s1 - s0 for s0, s1 in ranges]
    assert max(lens) - min(lens) <= da_ops.MMA_UNIT + S % da_ops.MMA_UNIT


def _long_case(G, Hkv, S, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).bfloat16()
            for shape in ((1, G * Hkv, 128), (1, S, Hkv, 128), (1, S, Hkv, 128))]


@pytest.mark.parametrize("which", ["first", "middle", "last"])
@pytest.mark.parametrize("G,Hkv", [(7, 4), (4, 8)])
def test_long_card_tolerance_sees_a_lost_split(G, Hkv, which):
    """The row-scaled tolerance of the card's long-S kernel-1 tests fails
    an output that lost one split's slots (33 splits at G=7, 16 at Hkv 8
    on an H100), which moves each row by 20-50% of its own scale but the
    whole output by under 0.02, the floor ``_close`` gives any output
    below 1; the plain version stands in for the kernel."""
    S = 16384 + 33
    q, k, v = _long_case(G, Hkv, S, G)
    mask = torch.arange(S) <= 16384
    n = da_ops.mma_split_plan(1, Hkv, S, 132)
    s0, s1 = da_ops.split_range(S, {"first": 0, "middle": n // 2, "last": n - 1}[which], n)
    lost = mask.clone()
    lost[s0:s1] = False
    ref = decode_attention_ref(q, k, v, mask)
    _close_rows(ref, ref, torch.bfloat16)
    with pytest.raises(AssertionError):
        _close_rows(decode_attention_ref(q, k, v, lost), ref, torch.bfloat16)


@pytest.mark.parametrize("window", [0, 1, 3])
def test_long_card_tolerance_sees_a_lost_window(window):
    """The same for the window walk (one split a pair): a block that
    skipped one of its four 4096-slot windows of mask bits fails."""
    q, k, v = _long_case(4, 8, 16384, 17)
    mask = torch.ones(16384, dtype=torch.bool)
    lost = mask.clone()
    lost[window * 4096:(window + 1) * 4096] = False
    ref = decode_attention_ref(q, k, v, mask)
    with pytest.raises(AssertionError):
        _close_rows(decode_attention_ref(q, k, v, lost), ref, torch.bfloat16)


@pytest.mark.parametrize("name,ctx", MATRIX, ids=[f"{a}-{c}" for a, c in MATRIX])
def test_matrix_floor_equals_reference(name, ctx):
    """Each matrix cell's H100 floor from the port's copy equals the
    reference's; the paper's Table 9 quotes 4.58 ms (qwen2.5-7b, 2048)
    and 5.43 ms (llama-3.1-8b, 16384)."""
    got = floor_cell(get_config(name), GPU_H100, ctx)
    want = jax_floor.floor_cell(jax_get_config(name), jax_hardware.GPU_H100, ctx)
    assert got.t_floor_ms == pytest.approx(want.t_floor_ms, rel=1e-12)
    assert got.kv_bytes == want.kv_bytes and got.weight_bytes == want.weight_bytes
    table9 = {("qwen2.5-7b", 2048): 4.58, ("llama-3.1-8b", 16384): 5.43}
    if (name, ctx) in table9:
        assert got.t_floor_ms == pytest.approx(table9[(name, ctx)], abs=6e-3)
