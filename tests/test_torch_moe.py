"""The port's moe family against the JAX package's, on the CPU, in f32,
on reduced qwen2-moe-a2.7b (softmax top-2 of 8 experts plus a shared
MLP) and llama4-scout-17b-a16e (sigmoid top-1), with weights bridged
from the JAX ``Model.init`` and inputs made from a seed with numpy.

Covers ``moe_forward`` (y and the aux loss, token counts that drop slots
past capacity, reach the 256 rounding, and a capacity factor that drops
nothing), the router's tie rule, the model's prefill and decode logits,
forward's aux, greedy streams through ``DecodeEngine``, the
continuous-batching scheduler's event logs and streams (free lanes
route and take capacity too, so they must compute what the reference
computes), ``int4_fused``, ``tree_weight_traffic`` on a moe tree,
``step_program``'s arms and the serve CLI.

Tolerances: f32 values agree to 1e-5 (O(1) values; the frameworks sum
matmuls in different orders).  Greedy streams and event logs must be
identical.  ``int4_fused`` logits agree to 2e-2 absolute, as in
tests/test_torch_model.py: the JAX package multiplies by a bf16
dequantisation of the 2-D weights on the CPU, the port's plain int4
matmul scales in f32."""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SessionRequest as JaxRequest
from repro_torch.bridge import from_jax_params, to_tensor
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.attention import DECODE_BACKENDS
from repro_torch.models.model import Model
from repro_torch.quant import QuantizedTensor, quantize_tree, tree_weight_traffic
from repro_torch.serving import DecodeEngine, SessionRequest

MOE = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
CPU = "cpu"
B, PROMPT, N_DECODE, MAX_LEN = 2, 12, 8, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(name, **kw):
    jcfg = jax_get_config(name).reduced().replace(dtype="float32", **kw)
    return jcfg, get_config(name).reduced().replace(dtype="float32", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _moe_params(name, seed=0):
    """One MoE block's params: the JAX tree and the port's copy."""
    jcfg, _ = _cfgs(name)
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return p, _to_port(_np(p))


def _to_port(node):
    if isinstance(node, dict):
        return {k: _to_port(v) for k, v in node.items()}
    return to_tensor(node, CPU)


# ---------------------------------------------------------------- moe_forward
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("T", [1, 4, 24, 1024])
@pytest.mark.parametrize("name", MOE)
def test_moe_forward_matches_jax(name, T, cf):
    jcfg, cfg = _cfgs(name, capacity_factor=cf)
    jp, p = _moe_params(name)
    x = np.random.default_rng(T).standard_normal((2, T // 2 or 1, cfg.d_model),
                                                 dtype=np.float32)
    if T == 1:
        x = x[:1]
    y_ref, aux_ref = jax_moe.moe_forward(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), **TOL)
    # what the case exercises: drops past capacity at cf 1.25 and 24
    # tokens, none at cf 8, the 256 rounding at T=1024
    idx, _, _ = moe._route(p, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
    k = max(cfg.top_k, 1)
    cap = moe.capacity_for(T, k, cf, cfg.n_experts)
    load = int(torch.bincount(idx.reshape(-1), minlength=cfg.n_experts).max())
    if cf == 8.0:
        assert load <= cap
    elif T == 24:
        assert load > cap
    if T == 1024 and name == "qwen2-moe-a2.7b" and cf == 1.25:
        assert cap == 512     # int(1024 * 2 * 1.25 / 8) = 320, rounded up
    _, no_aux = moe.moe_forward(p, torch.from_numpy(x), cfg, with_aux=False)
    assert no_aux is None


@pytest.mark.parametrize("name", MOE)
def test_router_ties_pick_the_lower_expert(name):
    """Three duplicated router columns scaled up: their equal logits top
    every token, so top-2 (qwen2-moe) must take the two lower indices and
    top-1 (llama4's argmax) the lowest, as ``jax.lax.top_k`` and
    ``jnp.argmax`` do; the whole layer must match the reference."""
    jcfg, cfg = _cfgs(name)
    jp, _ = _moe_params(name, seed=1)
    np_p = _np(jp)
    router = np_p["router"].copy()
    col = 10 * router[:, 1]
    for e in (1, 4, 6):
        router[:, e] = col
    np_p = dict(np_p, router=router)
    p = _to_port(np_p)
    x = np.random.default_rng(5).standard_normal((1, 6, cfg.d_model),
                                                 dtype=np.float32)
    x *= np.sign(x @ col)[..., None]         # the tied logits positive: on top
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    logits = xt @ p["router"]
    assert torch.equal(logits[:, 1], logits[:, 4]) and torch.equal(logits[:, 1], logits[:, 6])
    idx, gates, _ = moe._route(p, xt, cfg)
    top = [[1, 4]] if cfg.top_k == 2 else [[1]]
    assert idx.tolist() == top * 6
    ref_idx, ref_gates, _ = jax_moe._route(
        jax.tree_util.tree_map(jnp.asarray, np_p), jnp.asarray(xt.numpy()), jcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref_gates), **TOL)
    y_ref, _ = jax_moe.moe_forward(jax.tree_util.tree_map(jnp.asarray, np_p),
                                   jnp.asarray(x), jcfg)
    y, _ = moe.moe_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)


def test_top_k_lower_first_is_stable():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.0, 0.0, 0.0]])
    vals, idx = moe.top_k_lower_first(probs, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


# ---------------------------------------------------------------- the model
def _perturb(p, rng):
    """Noise on biases and norm weights (JAX init sets zeros and ones)."""
    def visit(node, name=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if name in ("bq", "bk", "bv", "norm1", "norm2", "final_norm"):
            return node + 0.1 * rng.standard_normal(node.shape).astype(node.dtype)
        return node
    return visit(p)


@functools.lru_cache(maxsize=None)
def _case(name, quant="bf16", batch=B):
    """JAX side: numpy params, tokens, prefill + teacher-forced decode
    logits, forward's logits and aux, greedy streamed and fused tokens."""
    jcfg, _ = _cfgs(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    np_params = _perturb(_np(JaxModel(jcfg).init(jax.random.PRNGKey(0))), rng)
    tokens = rng.integers(0, jcfg.vocab_size, (B, PROMPT + N_DECODE)).astype(np.int32)
    tokens = tokens[:batch]
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    eng = JaxEngine(JaxModel(jcfg), jparams, quant_path=quant)
    logits, cache = eng.prefill({"tokens": jnp.asarray(tokens[:, :PROMPT])}, MAX_LEN)
    steps = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = eng._step(eng.params, cache,
                                  jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]))
        steps.append(np.asarray(logits))
    if quant != "bf16":
        return np_params, _np(eng.params), tokens, steps
    fwd = JaxModel(jcfg).forward(jparams, {"tokens": jnp.asarray(tokens)})
    batch = {"tokens": jnp.asarray(tokens[:, :PROMPT])}
    streams = (np.asarray(eng.generate_streamed(batch, max_len=MAX_LEN,
                                                n_new=N_DECODE).tokens),
               np.asarray(eng.generate_fused(batch, max_len=MAX_LEN,
                                             n_new=N_DECODE).tokens))
    return np_params, tokens, steps, _np(fwd), streams


def _run_port(model, params, tokens):
    cache = model.init_cache(tokens.shape[0], MAX_LEN)
    toks = torch.from_numpy(tokens)
    logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
    out = [logits]
    for i in range(N_DECODE):
        logits, cache = model.decode_step(params, cache,
                                          toks[:, PROMPT + i:PROMPT + i + 1])
        out.append(logits)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_logits_match_jax(name, backend):
    np_params, tokens, ref, _, _ = _case(name)
    _, cfg = _cfgs(name)
    model = Model(cfg, decode_backend=backend, device=CPU)
    got = _run_port(model, from_jax_params(np_params, cfg, CPU), tokens)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("name", MOE)
def test_forward_logits_and_aux_match_jax(name):
    np_params, tokens, _, (logits, aux), _ = _case(name)
    _, cfg = _cfgs(name)
    model = Model(cfg, device=CPU)
    got, got_aux = model.forward(from_jax_params(np_params, cfg, CPU),
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), logits, **TOL)
    np.testing.assert_allclose(float(got_aux), float(aux), **TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("name", MOE)
def test_greedy_streams_match_jax(name):
    np_params, tokens, _, _, (streamed, fused) = _case(name)
    _, cfg = _cfgs(name)
    eng = DecodeEngine(Model(cfg, decode_backend="cuda", device=CPU),
                       from_jax_params(np_params, cfg, CPU))
    batch = {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
    s = eng.generate_streamed(batch, max_len=MAX_LEN, n_new=N_DECODE)
    f = eng.generate_fused(batch, max_len=MAX_LEN, n_new=N_DECODE)
    np.testing.assert_array_equal(s.tokens.numpy(), streamed)
    np.testing.assert_array_equal(f.tokens.numpy(), fused)



def test_paged_write_rows_last_lane_wins():
    """A paged decode step's K/V rows: inactive lanes go to the garbage
    page 0, and lanes that land on one row (here two inactive lanes and
    an active free lane, all at offset 4 of page 0) all write the last
    such lane's values, so the row holds a serial write's result (the
    reference's, which free lanes read and route through the experts)
    whatever order the card's scatter takes."""
    from repro_torch.models.attention import paged_write_rows
    block_table = torch.tensor([[1, 2], [0, 0], [3, 4], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([5, 4, 20, 4], dtype=torch.int32)
    active = torch.tensor([True, False, False, True])
    page, off, writer = paged_write_rows(block_table, pos, 16, active)
    assert page.tolist() == [1, 0, 0, 0]
    assert off.tolist() == [5, 4, 4, 4]
    assert writer.tolist() == [0, 3, 3, 3]
    page, off, writer = paged_write_rows(block_table, pos, 16)
    assert page.tolist() == [1, 0, 4, 0] and writer.tolist() == [0, 3, 2, 3]

def test_int4_fused_matches_jax():
    """int4_fused on a moe tree: the expert stacks quantise to the same
    codes as the reference's and the logits agree to 2e-2.  One sequence:
    at batch 2 the two lanes share capacity 1, and the 2-D linears'
    difference (bf16 dequantisation in the JAX package, f32 scaling in
    the port) moves one lane's top-k choice at step 1, a discontinuity no
    tolerance covers."""
    name = "qwen2-moe-a2.7b"
    np_params, q_np, tokens, ref = _case(name, quant="int4_fused", batch=1)
    _, cfg = _cfgs(name)
    bridged = from_jax_params(q_np, cfg, CPU)
    ours = quantize_tree(from_jax_params(np_params, cfg, CPU), "int4_fused")
    for a, b in zip(bridged["blocks"], ours["blocks"]):
        for key in ("w_gate", "w_up", "w_down"):
            qa, qb = a["moe"][key], b["moe"][key]
            assert isinstance(qa, QuantizedTensor) and qa.ndim == 3
            assert (qa.bits, qa.path, qa.group) == (qb.bits, qb.path, qb.group)
            assert torch.equal(qa.data, qb.data) and torch.equal(qa.scales, qb.scales)
        assert not isinstance(a["moe"]["router"], QuantizedTensor)
        assert all(isinstance(w, QuantizedTensor) for w in a["moe"]["shared"].values())
    got = _run_port(Model(cfg, decode_backend="cuda", device=CPU), bridged, tokens)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2, err_msg=f"step {i}")


def test_weight_traffic_charges_the_expert_route(monkeypatch):
    """``tree_weight_traffic`` of an int4_fused moe tree: the 2-D
    linears (attention, shared MLP) are charged codes + scales (the int4
    kernel's read), each 3-D expert stack codes + scales + the bf16 copy
    ``expert_einsum`` writes and reads back — and the route really
    dequantises each stack once per use."""
    from repro_torch.quant import paths
    _, cfg = _cfgs("qwen2-moe-a2.7b")
    model = Model(cfg, device=CPU)
    params = quantize_tree(model.init(torch.Generator().manual_seed(0)),
                           "int4_fused")
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def stack(K, N):    # int4 codes, f32 scales per group of min(128, K), bf16 copy
        return E * K * N // 2 + E * (K // min(128, K)) * N * 4 + 2 * E * K * N * 2
    per_block = 2 * stack(D, F) + stack(F, D) + D * E * 4 + 2 * D * 4   # + router, norms
    attn = params["blocks"][0]["attn"]
    shared = params["blocks"][0]["moe"]["shared"]
    for w in list(attn.values()) + list(shared.values()):
        if isinstance(w, QuantizedTensor):
            assert w.int4_kernel
            per_block += w.data.numel() + w.scales.numel() * 4
        else:
            per_block += w.numel() * 4                      # f32 biases
    head = 2 * cfg.vocab_size * D * 4 + D * 4              # embed, lm_head, final norm
    assert tree_weight_traffic(params) == cfg.n_layers * per_block + head
    for key in ("w_gate", "w_up", "w_down"):
        assert not params["blocks"][0]["moe"][key].int4_kernel
    calls = []
    real = paths.dequantize
    monkeypatch.setattr(paths, "dequantize",
                        lambda w, dt: calls.append(w.shape) or real(w, dt))
    cache = model.init_cache(1, 8)
    model.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, cache)
    assert sorted(calls) == sorted([(E, D, F), (E, D, F), (E, F, D)] * cfg.n_layers)


# ---------------------------------------------------------------- step_program
def test_step_program_arms_match_decode_step():
    """The eager, stage_jit and full_jit executors of ``step_program``
    over a moe model: logits and cache bit-equal to plain
    ``decode_step`` calls from the same prefilled cache (on the CPU every
    arm runs the step's own ops)."""
    name = "qwen2-moe-a2.7b"
    np_params, tokens, _, _, _ = _case(name)
    _, cfg = _cfgs(name)
    model = Model(cfg, device=CPU)
    params = from_jax_params(np_params, cfg, CPU)
    toks = torch.from_numpy(tokens)
    base = model.init_cache(B, MAX_LEN)
    model.prefill(params, {"tokens": toks[:, :PROMPT]}, base)
    want_cache = {k: v.clone() for k, v in base.items()}
    want = [model.decode_step(params, want_cache, toks[:, PROMPT + i:PROMPT + i + 1])[0]
            for i in range(3)]
    for mode in ("eager", "stage_jit", "full_jit"):
        cache = {k: v.clone() for k, v in base.items()}
        run = model.step_program(params, cache).executor(mode)
        for i in range(3):
            out = run({"tokens": toks[:, PROMPT + i:PROMPT + i + 1], "cache": cache})
            assert torch.equal(out["logits"], want[i]), (mode, i)
        for k in cache:
            assert torch.equal(cache[k], want_cache[k]), (mode, k)


# ---------------------------------------------------------------- bridge
def test_bridge_carries_moe_keys_unchanged():
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b")
    np_params = _np(JaxModel(jcfg).init(jax.random.PRNGKey(2)))
    port = from_jax_params(np_params, cfg, CPU)
    for i, bp in enumerate(port["blocks"]):
        ref = np_params["blocks"]["moe"]
        assert set(bp["moe"]) == set(ref) == {"router", "w_gate", "w_up", "w_down",
                                              "shared"}
        for key in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(bp["moe"][key].numpy(), ref[key][i])
        for key, w in bp["moe"]["shared"].items():
            np.testing.assert_array_equal(w.numpy(), ref["shared"][key][i])
    fresh = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, fresh["blocks"][0])) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, port["blocks"][0]))
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert fresh["blocks"][0]["moe"][key].shape == port["blocks"][0]["moe"][key].shape


# ---------------------------------------------------------------- scheduler
@functools.lru_cache(maxsize=None)
def _engines(jax_route, port_route):
    name = "qwen2-moe-a2.7b"
    jcfg, cfg = _cfgs(name)
    np_params = _np(JaxModel(jcfg).init(jax.random.PRNGKey(3)))
    jeng = JaxEngine(JaxModel(jcfg, decode_backend=jax_route),
                     jax.tree_util.tree_map(jnp.asarray, np_params))
    peng = DecodeEngine(Model(cfg, decode_backend=port_route, device=CPU),
                        from_jax_params(np_params, cfg, CPU))
    return jeng, peng


def _requests():
    """Five sessions through three slots: slot 0's sessions are short, so
    it frees while slots 1 and 2 still decode (a free lane below live
    ones, routed with token 0), and at the end fewer sessions than
    slots remain."""
    rng = np.random.default_rng(11)
    spec = [(5, 2), (9, 9), (7, 11), (4, 3), (6, 2)]
    return [(f"s{i}", rng.integers(0, 256, n).astype(np.int32), new)
            for i, (n, new) in enumerate(spec)]


def _serve(reqs, jax_route, port_route, **kw):
    jeng, peng = _engines(jax_route, port_route)
    ref = jeng.generate_continuous([JaxRequest(*r) for r in reqs], **kw)
    got = peng.generate_continuous([SessionRequest(*r) for r in reqs], **kw)
    assert got.events == ref.events
    for sid, _, _ in reqs:
        np.testing.assert_array_equal(got.tokens_for(sid), ref.tokens_for(sid),
                                      err_msg=sid)
    for field in ("preemptions", "prefill_tokens", "decode_steps",
                  "step_kv_blocks", "horizon_hist"):
        assert getattr(got, field) == getattr(ref, field), field
    return got


def _free_below_live(res):
    """Whether some decode tick ran with slot 0 free and a higher slot
    live: read off the event log."""
    live, seen = {}, False
    for ev in res.events:
        if ev[0] == "admit":
            live[ev[2]] = ev[1]
        elif ev[0] == "finish":
            live.pop(ev[2], None)
        elif ev[0] == "token" and ev[2] > 0 and 0 not in live:
            seen = True
    return seen


def test_scheduler_contiguous_matches_jax():
    got = _serve(_requests(), "sdpa", "sdpa", n_slots=3, max_len=32)
    assert _free_below_live(got)


def test_scheduler_paged_matches_jax():
    got = _serve(_requests(), "pallas", "cuda", n_slots=3, max_len=32,
                 paged=True, page_size=4)
    assert _free_below_live(got)


def test_scheduler_paged_horizon_k4_with_eos_matches_jax():
    reqs = _requests()
    _, peng = _engines("sdpa", "sdpa")
    base = peng.generate_continuous([SessionRequest(*r) for r in reqs],
                                    n_slots=3, max_len=32, paged=True, page_size=4)
    eos = int(base.tokens_for("s2")[3])
    got = _serve(reqs, "sdpa", "sdpa", n_slots=3, max_len=32, paged=True,
                 page_size=4, steps_per_tick=4, eos_id=eos)
    assert any(len(got.tokens_for(sid)) < n for sid, _, n in reqs), \
        "EOS never cut a session short"


# ---------------------------------------------------------------- serve CLI
def test_serve_cli_moe_batch1_and_paged(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
                "--prompt-len", "8", "--new-tokens", "4", "--timed"])
    out = capsys.readouterr().out
    assert "generated (1, 4) tokens on cpu" in out
    res = serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
                      "--paged", "--slots", "2", "--sessions", "3",
                      "--prompt-len", "6", "--new-tokens", "3", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "served 3 sessions through 2 slots" in out
    assert {sid: len(s.tokens) for sid, s in res.sessions.items()} == \
        {f"session{i}": 3 + (i * 5) % 4 for i in range(3)}
