"""The port's continuous-batching scheduler against the JAX package's,
on the CPU, on reduced qwen2.5-3b in f32 with the same (bridged)
weights and the same ``SessionRequest``s.

Each case compares the whole event log (admissions, tokens, finishes,
preemptions, in order) and every session's greedy token stream; both
must be identical.  Routes: the JAX package's ``decode_backend="pallas"``
(its kernels in interpret mode) against the port's ``"cuda"`` (the
kernels' plain versions on CPU tensors), and ``"sdpa"`` (the gather
route on paged caches) on both sides.  f32 because bf16 attention rounds
probabilities to bf16 before the PV product, a backend-specific rounding
that can flip a greedy tie.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SessionRequest as JaxRequest
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import DecodeEngine, SessionRequest

NAME = "qwen2.5-3b"
ROUTES = [("pallas", "cuda"), ("sdpa", "sdpa")]


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jax_get_config(NAME).reduced().replace(dtype="float32")
    params = JaxModel(jcfg).init(jax.random.PRNGKey(3))
    return jcfg, params, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _engines(jax_route, port_route, int8=False):
    jcfg, jparams, np_params = _weights()
    cfg = get_config(NAME).reduced().replace(dtype="float32")
    jeng = JaxEngine(JaxModel(jcfg, decode_backend=jax_route), jparams,
                     kv_dtype=jnp.int8 if int8 else None)
    peng = DecodeEngine(Model(cfg, decode_backend=port_route, device="cpu"),
                        from_jax_params(np_params, cfg, "cpu"),
                        kv_dtype=torch.int8 if int8 else None)
    return jeng, peng


def _requests(n, *, lengths=(5, 9), base_new=3, seed=0, preamble=0):
    """``n`` sessions of mixed prompt lengths and budgets; ``preamble``
    tokens shared by every prompt (the prefix-sharing workload)."""
    rng = np.random.default_rng(seed)
    vocab = _weights()[0].vocab_size
    common = rng.integers(0, vocab, preamble).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, lengths[i % len(lengths)]).astype(np.int32)
        out.append((f"s{i}", np.concatenate([common, tail]), base_new + i % 4))
    return out


def _serve(reqs, jax_route, port_route, *, int8=False, **kw):
    jeng, peng = _engines(jax_route, port_route, int8)
    ref = jeng.generate_continuous([JaxRequest(*r) for r in reqs], **kw)
    got = peng.generate_continuous([SessionRequest(*r) for r in reqs], **kw)
    assert got.events == ref.events
    for sid, _, _ in reqs:
        np.testing.assert_array_equal(got.tokens_for(sid), ref.tokens_for(sid),
                                      err_msg=sid)
    for field in ("preemptions", "prefill_tokens", "prefix_hits", "cow_copies",
                  "decode_steps", "step_kv_blocks", "horizon_hist"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.step_cache_size is None      # nothing is captured on the CPU
    return ref, got


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_contiguous_slotted(jax_route, port_route):
    _serve(_requests(5), jax_route, port_route, n_slots=2, max_len=24)


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_paged_full_backing(jax_route, port_route):
    _serve(_requests(5), jax_route, port_route, n_slots=3, max_len=24,
           paged=True, page_size=4)


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_paged_oversubscribed_preempts(jax_route, port_route):
    reqs = [("a", np.arange(4, dtype=np.int32), 14),
            ("b", np.arange(5, 10, dtype=np.int32), 14),
            ("c", np.arange(3, dtype=np.int32) + 7, 6)]
    _, got = _serve(reqs, jax_route, port_route, n_slots=2, max_len=24,
                    paged=True, page_size=4, n_pages=1 + 6)
    assert got.preemptions >= 1, "the pool was sized to force a preemption"


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_paged_chunked_prefill(jax_route, port_route):
    _serve(_requests(4, lengths=(9, 13)), jax_route, port_route, n_slots=2,
           max_len=24, paged=True, page_size=4, prefill_chunk=4)


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_prefix_cache_with_cow(jax_route, port_route):
    """A shared 8-token preamble (two pages) plus an exact duplicate of a
    page-aligned prompt: the duplicate replays its last token through
    decode after a copy-on-write of the last shared page."""
    reqs = _requests(3, preamble=8, lengths=(3, 5))
    reqs.append(("dup", reqs[0][1][:8].copy(), 4))
    reqs.append(("dup2", reqs[0][1][:8].copy(), 3))
    _, got = _serve(reqs, jax_route, port_route, n_slots=2, max_len=24,
                    paged=True, page_size=4, prefix_cache=True)
    assert got.prefix_hits >= 2 and got.cow_copies >= 1


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_int8_kv_paged(jax_route, port_route):
    _serve(_requests(4), jax_route, port_route, int8=True, n_slots=2,
           max_len=24, paged=True, page_size=4, n_pages=1 + 7)


@pytest.mark.parametrize("jax_route,port_route", ROUTES)
def test_horizon_k4_with_eos(jax_route, port_route):
    """K=4 macro-ticks with an EOS token taken from the middle of a
    session's stream, so a lane ends mid-horizon and is trimmed."""
    reqs = _requests(5, base_new=5)
    _, peng = _engines(jax_route, port_route)
    base = peng.generate_continuous([SessionRequest(*r) for r in reqs],
                                    n_slots=2, max_len=24, paged=True,
                                    page_size=4)
    eos = int(base.tokens_for("s2")[2])
    _, got = _serve(reqs, jax_route, port_route, n_slots=2, max_len=24,
                    paged=True, page_size=4, steps_per_tick=4, eos_id=eos)
    assert any(len(got.tokens_for(sid)) < n for sid, _, n in reqs), \
        "EOS never cut a session short"



def test_adaptive_k():
    """Adaptive horizon: each macro-tick picks K from the 1/2/4 ladder by
    the virtual clock and the queue; the rungs picked match too."""
    _, got = _serve(_requests(5, base_new=5), "sdpa", "sdpa", n_slots=2,
                    max_len=24, paged=True, page_size=4, steps_per_tick=4,
                    adaptive_k=True)
    assert len(got.horizon_hist) >= 2


def test_serve_cli_paged_prefix_int8(capsys):
    """The launcher's paged continuous mode with prefix sharing and int8
    KV serves every session and prints its serving lines."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                      "--paged", "--prefix-cache", "--kv-quant", "int8",
                      "--slots", "3", "--sessions", "6", "--shared-prefix",
                      "16", "--prompt-len", "6", "--new-tokens", "4",
                      "--page-size", "8", "--steps-per-tick", "2", "--timed"])
    out = capsys.readouterr().out
    assert {sid: len(s.tokens) for sid, s in res.sessions.items()} == \
        {f"session{i}": 4 + (i * 5) % 5 for i in range(6)}
    assert "served 6 sessions through 3 slots" in out
    assert "prefix cache: " in out and res.prefix_hits >= 5
    assert "quantised serving: weights=bf16 kv=int8" in out
    assert "kv_quant=int8 floor" in out
