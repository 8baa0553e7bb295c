"""The port's vlm (Qwen2-VL: patch embeddings in, M-RoPE) and audio
(MusicGen: 4 codebooks summed in, 4 heads out) families against the JAX
package's, on the CPU, in f32, on the reduced configs, with weights
bridged from the JAX ``Model.init`` and inputs made from a seed with
numpy.

The vlm prompt is embeddings with (t, h, w) positions that differ from
one another (with t == h == w M-RoPE is plain RoPE and would hide a
wrong section order); decode feeds tokens.  The audio prompt is (B, S,
4) tokens, its logits (B, S, 4, V) and its greedy streams (B, N, 4).

Tolerances: f32 logits agree to 1e-5 (the frameworks sum matmuls in
different orders); greedy streams and event logs must be identical."""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SessionRequest as JaxRequest
from repro.serving import SlotScheduler as JaxScheduler
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models.attention import DECODE_BACKENDS
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine, SessionRequest, SlotScheduler

VLM, AUDIO = "qwen2-vl-2b", "musicgen-large"
CPU = "cpu"
B, PROMPT, N_DECODE, MAX_LEN = 2, 12, 8, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(name):
    return (jax_get_config(name).reduced().replace(dtype="float32"),
            get_config(name).reduced().replace(dtype="float32"))


def _perturb(p, rng):
    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if name in ("bq", "bk", "bv", "norm1", "norm2", "final_norm"):
            return node + 0.1 * rng.standard_normal(node.shape).astype(node.dtype)
        return node
    return visit(p)


def _inputs(name, cfg, rng):
    """(prompt batch as numpy, decode tokens (B, N_DECODE, ...))."""
    if cfg.family == "vlm":
        t = np.arange(PROMPT)
        thw = np.stack([t, t // 3, (5 * t) % 7], axis=-1)         # t, h, w differ
        pos = np.broadcast_to(thw, (B, PROMPT, 3)).astype(np.int32)
        embeds = rng.standard_normal((B, PROMPT, cfg.d_model)).astype(np.float32)
        dec = rng.integers(0, cfg.vocab_size, (B, N_DECODE)).astype(np.int32)
        return {"embeds": embeds, "positions": pos.copy()}, dec
    toks = rng.integers(0, cfg.vocab_size,
                        (B, PROMPT + N_DECODE, cfg.n_codebooks)).astype(np.int32)
    return {"tokens": toks[:, :PROMPT]}, toks[:, PROMPT:]


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX side: numpy params, inputs, prefill + teacher-forced decode
    logits, greedy streamed and fused tokens."""
    jcfg, _ = _cfgs(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0))), rng)
    batch, dec = _inputs(name, jcfg, rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    eng = JaxEngine(JaxModel(jcfg), jax.tree_util.tree_map(jnp.asarray, np_params))
    logits, cache = eng.prefill(jb, MAX_LEN)
    steps = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = eng._step(eng.params, cache, jnp.asarray(dec[:, i:i + 1]))
        steps.append(np.asarray(logits))
    streams = (np.asarray(eng.generate_streamed(jb, max_len=MAX_LEN,
                                                n_new=N_DECODE).tokens),
               np.asarray(eng.generate_fused(jb, max_len=MAX_LEN,
                                             n_new=N_DECODE).tokens))
    return np_params, batch, dec, steps, streams


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_prefill_and_decode_logits_match_jax(name, backend):
    np_params, batch, dec, ref, _ = _case(name)
    _, cfg = _cfgs(name)
    model = Model(cfg, decode_backend=backend, device=CPU)
    params = from_jax_params(np_params, cfg, CPU)
    cache = model.init_cache(B, MAX_LEN)
    logits, _ = model.prefill(params, _torch_batch(batch), cache)
    got = [logits]
    d = torch.from_numpy(dec)
    for i in range(N_DECODE):
        got.append(model.decode_step(params, cache, d[:, i:i + 1])[0])
    want_shape = ((B, 1, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks
                  else (B, 1, cfg.vocab_size))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == want_shape
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_greedy_streams_match_jax(name):
    np_params, batch, _, _, (streamed, fused) = _case(name)
    _, cfg = _cfgs(name)
    eng = DecodeEngine(Model(cfg, decode_backend="cuda", device=CPU),
                       from_jax_params(np_params, cfg, CPU))
    s = eng.generate_streamed(_torch_batch(batch), max_len=MAX_LEN, n_new=N_DECODE)
    f = eng.generate_fused(_torch_batch(batch), max_len=MAX_LEN, n_new=N_DECODE)
    want = (B, N_DECODE, cfg.n_codebooks) if cfg.n_codebooks else (B, N_DECODE)
    assert tuple(s.tokens.shape) == tuple(f.tokens.shape) == want
    np.testing.assert_array_equal(s.tokens.numpy(), streamed)
    np.testing.assert_array_equal(f.tokens.numpy(), fused)


def test_mrope_positions_matter():
    """The vlm's (t, h, w) positions reach the attention: the same
    embeddings at t == h == w give other logits."""
    np_params, batch, _, ref, _ = _case(VLM)
    _, cfg = _cfgs(VLM)
    model = Model(cfg, device=CPU)
    params = from_jax_params(np_params, cfg, CPU)
    flat = dict(batch, positions=np.repeat(batch["positions"][..., :1], 3, axis=-1))
    logits, _ = model.prefill(params, _torch_batch(flat), model.init_cache(B, MAX_LEN))
    assert float(np.abs(logits.numpy() - ref[0]).max()) > 1e-3
    logits, _ = model.forward(params, _torch_batch(batch))
    np.testing.assert_allclose(logits[:, -1:].numpy(), ref[0], **TOL)


def test_bridge_carries_codebook_tables_unchanged():
    jcfg, cfg = _cfgs(AUDIO)
    np_params = jax.tree_util.tree_map(
        np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(2)))
    port = from_jax_params(np_params, cfg, CPU)
    K, V, D = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    for key in ("embed", "lm_head"):
        assert tuple(port[key].shape) == np_params[key].shape == (K, V, D)
        np.testing.assert_array_equal(port[key].numpy(), np_params[key])
    fresh = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    assert tuple(fresh["embed"].shape) == tuple(fresh["lm_head"].shape) == (K, V, D)


def test_audio_step_program_arms_match_decode_step():
    np_params, batch, dec, _, _ = _case(AUDIO)
    _, cfg = _cfgs(AUDIO)
    model = Model(cfg, device=CPU)
    params = from_jax_params(np_params, cfg, CPU)
    base = model.init_cache(B, MAX_LEN)
    model.prefill(params, _torch_batch(batch), base)
    d = torch.from_numpy(dec)
    want_cache = {k: v.clone() for k, v in base.items()}
    want = [model.decode_step(params, want_cache, d[:, i:i + 1])[0] for i in range(3)]
    for mode in ("eager", "stage_jit", "full_jit"):
        cache = {k: v.clone() for k, v in base.items()}
        run = model.step_program(params, cache).executor(mode)
        for i in range(3):
            out = run({"tokens": d[:, i:i + 1], "cache": cache})
            assert torch.equal(out["logits"], want[i]), (mode, i)
        for k in cache:
            assert torch.equal(cache[k], want_cache[k]), (mode, k)


def test_audio_refuses_what_the_reference_refuses():
    """Continuous batching and ``steps_left`` masking serve single-codebook
    archs: both packages raise NotImplementedError with the same words."""
    jcfg, cfg = _cfgs(AUDIO)
    with pytest.raises(NotImplementedError) as ref:
        JaxScheduler(JaxModel(jcfg), None, n_slots=2, max_len=16)
    model = Model(cfg, device=CPU)
    with pytest.raises(NotImplementedError) as got:
        SlotScheduler(model, None, n_slots=2, max_len=16)
    assert str(got.value) == str(ref.value)
    cache = model.init_cache(1, 8)
    with pytest.raises(NotImplementedError, match="single-codebook"):
        model.decode_steps(None, cache, torch.zeros((1, 1, 4), dtype=torch.int64),
                           steps_left=torch.ones(1, dtype=torch.int32), horizon=1)


def test_vlm_paged_scheduler_matches_jax():
    """The vlm serves token sessions through the paged scheduler (M-RoPE
    at t == h == w), event for event with the reference."""
    jcfg, cfg = _cfgs(VLM)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       JaxModel(jcfg).init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    reqs = [(f"s{i}", rng.integers(0, 256, n).astype(np.int32), new)
            for i, (n, new) in enumerate([(5, 3), (9, 6), (7, 4), (6, 2)])]
    kw = dict(n_slots=2, max_len=24, paged=True, page_size=4, prefill_chunk=4)
    ref = JaxEngine(JaxModel(jcfg, decode_backend="pallas"),
                    jax.tree_util.tree_map(jnp.asarray, np_params)
                    ).generate_continuous([JaxRequest(*r) for r in reqs], **kw)
    got = DecodeEngine(Model(cfg, decode_backend="cuda", device=CPU),
                       from_jax_params(np_params, cfg, CPU)
                       ).generate_continuous([SessionRequest(*r) for r in reqs], **kw)
    assert got.events == ref.events
    for sid, _, _ in reqs:
        np.testing.assert_array_equal(got.tokens_for(sid), ref.tokens_for(sid))


@pytest.mark.parametrize("name,shape", [(VLM, "(1, 4)"), (AUDIO, "(1, 4, 4)")])
def test_serve_cli_batch1(name, shape, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", name, "--reduced", "--device", "cpu", "--prompt-len",
                "8", "--new-tokens", "4", "--timed"])
    out = capsys.readouterr().out
    assert f"generated {shape} tokens on cpu" in out
    assert "R_floor" in out


def test_serve_cli_audio_continuous_fails_in_the_scheduler():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="single-codebook"):
        serve.main(["--arch", AUDIO, "--reduced", "--device", "cpu",
                    "--continuous", "--slots", "2", "--sessions", "2"])


def test_serve_prompt_takes_the_reference_shapes():
    from repro_torch.launch.serve import prompt_batch
    vlm = prompt_batch(get_config(VLM), 1, 16, 0, CPU)
    assert set(vlm) == {"embeds", "positions"}
    assert vlm["embeds"].dtype == torch.bfloat16 and tuple(vlm["embeds"].shape) == (1, 16, 1536)
    assert torch.equal(vlm["positions"], torch.arange(16)[None, :, None].expand(1, 16, 3))
    audio = prompt_batch(get_config(AUDIO), 1, 16, 0, CPU)
    assert tuple(audio["tokens"].shape) == (1, 16, 4)
