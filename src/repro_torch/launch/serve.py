"""Serving launcher — batch-1 streaming decode, the paper's workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-7b \
      --prompt-len 2048 --new-tokens 32 --timed

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --reduced --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --prompt-len 2048 --new-tokens 32 --timed [--mode fused]

(the ssm and hybrid archs, ``mamba2-2.7b`` and ``zamba2-1.2b``, serve
batch-1 only; the vlm's batch-1 prompt is random patch embeddings with
M-RoPE positions, the audio's 4 codebooks of tokens), plus the
continuous-batching multi-session modes of the attention families
(dense, moe, vlm; slotted or paged KV cache, prefix sharing, int8 KV,
horizon-K ticks; the audio arch's codebooks raise in the scheduler, as
in the reference):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --reduced --device cpu --paged --slots 4 --sessions 8 --timed

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --reduced --device cpu --paged --prefix-cache --kv-quant int8 \
      --slots 3 --sessions 6 --shared-prefix 16 --timed

and the host-DRAM KV tier, trace replay with SLO reports and seeded
fault plans on the paged scheduler:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --reduced --device cpu --paged --slots 2 --sessions 6 --pages 12 \
      --kv-tier host --trace poisson --fault-plan mixed --slo-json

Runs on the CUDA card unless ``--device cpu`` is given; weights are
random, drawn on the device from ``--seed``.  ``--spans PATH`` records the
port's spans and their device intervals (``core/spans.py``) over the run
and writes them to PATH as Chrome-trace JSON, for Perfetto.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import floor as fl
from repro_torch.core import spans
from repro_torch.core.dispatch import MODES
from repro_torch.core.hardware import GPU_H100
from repro_torch.models.attention import DECODE_BACKENDS
from repro_torch.models.model import ATTENTION_FAMILIES, Model
from repro_torch.quant import WEIGHT_PATHS
from repro_torch.serving import DecodeEngine, SessionRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quant", default="bf16", choices=WEIGHT_PATHS)
    ap.add_argument("--weights", default=None,
                    choices=("int8", "int4") + WEIGHT_PATHS,
                    help="weight quantisation path (alias for --quant; bare "
                         "'int8'/'int4' select the fused path)")
    ap.add_argument("--mode", default="streamed", choices=["streamed", "fused"])
    ap.add_argument("--decode-backend", default="cuda", choices=DECODE_BACKENDS,
                    help="decode attention route; 'cuda' is the hand-written "
                         "kernel (its plain version on --device cpu)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--timed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="KV cache quantisation: int8 codes + per-(token, "
                         "head) f32 scales; on --paged the 'cuda' route "
                         "dequantises inside the paged kernel")
    # continuous batching (slotted KV cache, multi-session churn)
    ap.add_argument("--continuous", action="store_true",
                    help="serve --sessions sessions of mixed prompt/target "
                         "lengths through --slots cache slots")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--dispatch", default="full_jit", choices=list(MODES),
                    help="continuous-batching decode dispatch: full_jit = "
                         "the whole step as one captured CUDA graph; "
                         "stage_jit = one graph per layer; eager = per-op "
                         "launches (the dispatch A/B arms)")
    ap.add_argument("--steps-per-tick", type=int, default=1,
                    help="horizon K: K decode steps with on-device sampling "
                         "per dispatch, one token transfer per macro-tick")
    ap.add_argument("--adaptive-k", action="store_true",
                    help="pick each macro-tick's horizon from the "
                         "[1, --steps-per-tick] halving ladder by load")
    ap.add_argument("--paged", action="store_true",
                    help="serve out of a paged KV cache: a page pool + "
                         "per-slot block tables (implies --continuous)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=None,
                    help="pool pages incl. the garbage sentinel; below "
                         "1 + slots*ceil(max_len/page_size) the pool is "
                         "oversubscribed (default: full backing)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts in chunks of this many tokens "
                         "(multiple of --page-size), between decode ticks")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across "
                         "sessions through copy-on-write pages (implies "
                         "--paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical tokens to every "
                         "session's prompt (what --prefix-cache shares)")
    # host-DRAM KV page tier (serving/memory/tiers.py)
    ap.add_argument("--kv-tier", default="none", choices=["none", "host"],
                    help="with --paged: add a host-DRAM page tier — "
                         "preempted sessions park their full KV pages "
                         "host-side and re-admission restores them "
                         "instead of re-prefilling; LRU-evicted prefix "
                         "pages spill into a host prefix index "
                         "(implies --paged)")
    ap.add_argument("--tier-policy", default="spill",
                    choices=["prefer-device", "spill", "lookahead"],
                    help="placement/migration policy for --kv-tier host: "
                         "prefer-device never spills (the control arm), "
                         "spill migrates exactly on eviction, lookahead "
                         "additionally pre-copies the predicted next "
                         "victim's cold pages on idle ticks")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host pool capacity in pages (default: one full "
                         "device pool)")
    # trace-driven load replay (serving/trace.py)
    ap.add_argument("--trace", default=None, choices=["poisson", "bursty"],
                    help="replay a seeded arrival trace instead of the "
                         "all-at-once session wave: requests are "
                         "released into the admission queue by virtual "
                         "arrival time and the run reports per-class "
                         "TTFT / per-token latency percentiles and "
                         "goodput-under-SLO on the scheduler's "
                         "deterministic virtual clock (implies "
                         "--continuous; --sessions sets the request "
                         "count)")
    ap.add_argument("--trace-seed", type=int, default=13,
                    help="trace generator seed (same seed -> "
                         "byte-identical trace)")
    ap.add_argument("--rate", type=float, default=25.0,
                    help="mean arrival rate of the trace, requests per "
                         "virtual second")
    ap.add_argument("--no-priority-preemption", action="store_true",
                    help="page-pressure eviction picks the youngest "
                         "session regardless of priority (the FIFO "
                         "baseline) instead of "
                         "lowest-priority-youngest")
    ap.add_argument("--slo-json", action="store_true",
                    help="with --trace: print the full SLO report as "
                         "JSON instead of the one-line summary")
    # fault injection + graceful degradation (serving/faults.py)
    ap.add_argument("--fault-plan", default=None,
                    help="with --trace: arm a chaos plan against the "
                         "replay — 'mixed' generates a seeded plan over "
                         "every fault kind (--chaos-seed; same seed -> "
                         "byte-identical schedule), anything else is "
                         "read as a fault-plan file (plan_to_text "
                         "format).  Injected copy failures retry with "
                         "backoff then degrade to re-prefill, poisoned "
                         "logits quarantine their lane, aborts free the "
                         "session's slot and pages with a terminal "
                         "event")
    ap.add_argument("--chaos-seed", type=int, default=7,
                    help="seed for --fault-plan mixed")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="retries per failed host-tier copy before the "
                         "restore degrades to re-prefill (backoff is "
                         "charged to the virtual clock)")
    ap.add_argument("--session-ttl", type=float, default=None,
                    help="per-session deadline in virtual seconds since "
                         "arrival; overdue sessions are expired and "
                         "their slot/pages freed")
    ap.add_argument("--restore-patience", type=int, default=0,
                    help="ticks a parked host copy is held while the "
                         "page gate can't cover its restore before "
                         "re-prefill admission supersedes it")
    ap.add_argument("--spans", default=None, metavar="PATH",
                    help="record the port's spans over the run and write "
                         "them, with their device intervals, to PATH as "
                         "Chrome-trace JSON (for Perfetto)")
    args = ap.parse_args(argv)
    if args.weights:
        args.quant = {"int8": "int8_fused",
                      "int4": "int4_fused"}.get(args.weights, args.weights)
    if args.trace:
        args.continuous = True
    if args.prefix_cache or args.kv_tier != "none":
        args.paged = True
    if args.paged:
        args.continuous = True

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family not in ATTENTION_FAMILIES and (
            args.continuous or args.kv_quant != "none"):
        ap.error(f"--continuous, --paged, --prefix-cache, --kv-tier, --trace "
                 f"and --kv-quant serve the attention families; {args.arch} "
                 f"is {cfg.family!r} "
                 "(batch-1 streamed or fused decode only)")
    if args.dispatch != "full_jit" and (args.paged or args.steps_per_tick > 1):
        ap.error(f"--dispatch {args.dispatch}: --paged serving and horizon-K "
                 "ticks (--steps-per-tick > 1) run the full_jit arm only")
    model = Model(cfg, decode_backend=args.decode_backend, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    engine = DecodeEngine(
        model, params, quant_path=args.quant,
        kv_dtype=torch.int8 if args.kv_quant == "int8" else None)
    if not args.spans:
        return serve(engine, cfg, args)
    with spans.recording(model.device) as rec:
        rc = serve(engine, cfg, args)
    n = rec.chrome_trace(args.spans)
    print(f"spans: {n} written to {args.spans} (Chrome trace), "
          f"{rec.dropped} dropped")
    return rc


def serve(engine: DecodeEngine, cfg, args):
    """The run ``args`` ask for: a trace replay, continuous batching or
    batch-1 generation."""
    if args.trace:
        return serve_trace(engine, cfg, args)
    if args.continuous:
        return serve_continuous(engine, cfg, args)
    model = engine.model
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed,
                         model.device)
    max_len = args.prompt_len + args.new_tokens + 1

    if args.mode == "fused":
        res = engine.generate_fused(batch, max_len=max_len, n_new=args.new_tokens,
                                    temperature=args.temperature, seed=args.seed)
    else:
        res = engine.generate_streamed(batch, max_len=max_len,
                                       n_new=args.new_tokens,
                                       temperature=args.temperature,
                                       seed=args.seed, timed=args.timed)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    print(f"generated {tuple(res.tokens.shape)} tokens on {where}; "
          f"{res.tokens_per_s:.1f} tok/s")
    if args.timed and res.step_times_s:
        p50 = float(np.median(res.step_times_s)) * 1e3
        wb = 0.5 if args.quant.startswith("int4") else 1 if \
            args.quant.startswith("int8") else 2
        fc = fl.floor_cell(cfg, GPU_H100, args.prompt_len, weight_dtype_bytes=wb)
        print(f"p50 step {p50:.3f} ms on {where}; {GPU_H100.name} analytic "
              f"floor {fc.t_floor_ms:.4g} ms, R_floor "
              f"{fc.r_floor(p50 / 1e3):.4g}")
    print("first tokens:", res.tokens[0, :12].tolist())


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int, device):
    """The batch-1 prompt in the shapes of the reference's
    ``synthetic_batch``, drawn with numpy from ``seed``: tokens (B, S),
    or (B, S, K) with audio codebooks; for the vlm, bf16 ``embeds``
    (B, S, D) and ``positions`` 0..S-1 broadcast to (B, S, 3), no
    tokens."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        embeds = rng.standard_normal((batch, prompt_len, cfg.d_model),
                                     dtype=np.float32)
        pos = np.broadcast_to(np.arange(prompt_len)[None, :, None],
                              (batch, prompt_len, 3))
        return {"embeds": torch.from_numpy(embeds).to(device, torch.bfloat16),
                "positions": torch.from_numpy(pos.copy()).to(device)}
    shape = ((batch, prompt_len, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, prompt_len))
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape)).to(device)}


def mixed_requests(cfg, n_sessions: int, *, base_prompt: int,
                   base_new: int, seed: int, shared_prefix: int = 0):
    """Deterministic session mix: prompt lengths base..~2x base, token
    budgets base_new..~2x base_new (the reference's length formula),
    token ids from ``numpy.random.default_rng(seed + 1)``.
    ``shared_prefix`` prepends that many identical tokens to every
    prompt (the prefix-sharing workload)."""
    rng = np.random.default_rng(seed + 1)
    common = rng.integers(0, cfg.vocab_size, shared_prefix, dtype=np.int32)
    reqs = []
    for i in range(n_sessions):
        plen = base_prompt + (i * 7) % (base_prompt + 1)
        n_new = base_new + (i * 5) % (base_new + 1)
        prompt = rng.integers(0, cfg.vocab_size, plen, dtype=np.int32)
        reqs.append(SessionRequest(f"session{i}",
                                   np.concatenate([common, prompt]), n_new))
    return reqs


def serve_trace(engine: DecodeEngine, cfg, args):
    """Trace-driven load replay: generate a seeded arrival trace,
    release its requests by virtual arrival time through the continuous
    scheduler, and report the SLO metrics (TTFT / per-token latency
    percentiles, goodput-under-SLO) per session class.  Returns the
    ``ContinuousResult`` and the SLO report."""
    import json

    from repro_torch.serving import generate_trace, slo_report
    from repro_torch.serving.trace import bursty_config, poisson_config
    mk = bursty_config if args.trace == "bursty" else poisson_config
    tcfg = mk(seed=args.trace_seed, n_requests=args.sessions,
              vocab_size=cfg.vocab_size, rate_rps=args.rate)
    trace = generate_trace(tcfg)
    max_len = trace.max_len() + 1
    injector = None
    if args.fault_plan:
        from repro_torch.serving.faults import (FaultInjector, FaultPlanConfig,
                                                generate_fault_plan,
                                                plan_from_text, validate_plan)
        sids = [r.session_id for r in trace.requests]
        if args.fault_plan == "mixed":
            horizon = round(max(r.arrival_s for r in trace.requests)
                            + 0.25, 6)
            plan = generate_fault_plan(
                FaultPlanConfig(seed=args.chaos_seed, n_faults=12,
                                horizon_s=horizon), session_ids=sids)
        else:
            with open(args.fault_plan) as fh:
                plan = plan_from_text(fh.read())
            validate_plan(plan)
        injector = FaultInjector(plan)
    res = engine.generate_continuous(
        trace.requests, n_slots=args.slots, max_len=max_len,
        temperature=args.temperature, seed=args.seed,
        dispatch_mode=args.dispatch, paged=args.paged,
        page_size=args.page_size, n_pages=args.pages,
        prefill_chunk=args.prefill_chunk,
        steps_per_tick=args.steps_per_tick, timed=args.timed,
        prefix_cache=args.prefix_cache, adaptive_k=args.adaptive_k,
        priority_preemption=not args.no_priority_preemption,
        kv_tier=args.kv_tier, tier_policy=args.tier_policy,
        host_pages=args.host_pages,
        fault_injector=injector, retry_budget=args.retry_budget,
        session_ttl_s=args.session_ttl,
        restore_patience=args.restore_patience,
        self_audit=injector is not None)
    rep = slo_report(res, trace.classes)
    if args.slo_json:
        print(json.dumps(rep, indent=2, allow_nan=False))
        return res, rep
    dev = engine.model.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"replayed {args.trace} trace (seed {args.trace_seed}, "
          f"{len(trace.requests)} requests at {args.rate:g} req/s) through "
          f"{args.slots} slots on {where}, steps_per_tick="
          f"{args.steps_per_tick}{' adaptive' if args.adaptive_k else ''}: "
          f"{res.dispatches} decode dispatches, "
          f"{res.preemptions} preemptions, "
          f"virtual makespan {rep['makespan_s']:.3f}s")
    if res.kv_tier != "none":
        print(f"kv tier ({res.tier_policy}): {res.pages_spilled} spilled / "
              f"{res.pages_restored} restored pages, "
              f"{res.tier_restores} parked restores, "
              f"{res.host_prefix_hits} host prefix hits")
    if injector is not None:
        fc = " ".join(f"{k}:{v}" for k, v in res.fault_counts.items())
        print(f"chaos plan ({args.fault_plan}, seed {args.chaos_seed}): "
              f"{res.faults_injected} faults fired"
              f"{' (' + fc + ')' if fc else ''}")
        print(f"recovery: {res.save_retries}/{res.restore_retries} "
              f"save/restore retries "
              f"({res.retry_backoff_s * 1e3:.1f} ms virtual backoff), "
              f"{res.degraded_restores} degraded restores, "
              f"{res.corrupt_blobs} checksum rejects, "
              f"{res.quarantines} quarantines; sessions "
              f"{res.aborted_sessions} aborted / "
              f"{res.failed_sessions} failed / "
              f"{res.expired_sessions} expired")
    if rep["ttft"] is not None and rep["tpot"] is not None:
        print(f"ttft p50/p95/p99 {rep['ttft']['p50']:.4f}/"
              f"{rep['ttft']['p95']:.4f}/{rep['ttft']['p99']:.4f} s, "
              f"tpot p50/p95/p99 {rep['tpot']['p50']:.4f}/"
              f"{rep['tpot']['p95']:.4f}/{rep['tpot']['p99']:.4f} s "
              f"(virtual)")
    for name, c in rep["classes"].items():
        print(f"  class {name}: {c['sessions']} sessions, "
              f"slo_frac {c['slo_frac']:.2f} "
              f"(ttft<={c['slo_ttft_s']:g}s, tpot_p95<={c['slo_tpot_s']:g}s), "
              f"goodput {c['goodput_tok_s']:.1f} tok/s")
    dropped = (f", {rep['failed_sessions']} dropped"
               if rep.get("failed_sessions") else "")
    print(f"goodput under SLO: {rep['goodput_tok_s']:.1f} tok/s "
          f"({rep['slo_sessions']}/{rep['sessions']} sessions in SLO"
          f"{dropped}, "
          f"{rep.get('tokens_per_s_virtual', 0.0):.1f} tok/s served)")
    if res.adaptive_k:
        hist = " ".join(f"K{k}:{v}" for k, v in
                        sorted(res.horizon_hist.items()))
        print(f"adaptive horizon histogram: {hist}")
    return res, rep


def serve_continuous(engine: DecodeEngine, cfg, args):
    reqs = mixed_requests(cfg, args.sessions, base_prompt=args.prompt_len,
                          base_new=args.new_tokens, seed=args.seed,
                          shared_prefix=args.shared_prefix)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    res = engine.generate_continuous(
        reqs, n_slots=args.slots, max_len=max_len,
        temperature=args.temperature, seed=args.seed,
        dispatch_mode=args.dispatch, paged=args.paged,
        page_size=args.page_size, n_pages=args.pages,
        prefill_chunk=args.prefill_chunk,
        steps_per_tick=args.steps_per_tick, timed=args.timed,
        prefix_cache=args.prefix_cache, adaptive_k=args.adaptive_k,
        kv_tier=args.kv_tier, tier_policy=args.tier_policy,
        host_pages=args.host_pages)
    n_tok = sum(len(s.tokens) for s in res.sessions.values())
    layout = "paged" if args.paged else "contiguous"
    backend = engine.model.decode_backend
    dev = engine.model.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {len(res.sessions)} sessions through {args.slots} slots "
          f"({args.dispatch}, {layout}, attn={backend}) on {where}: {n_tok} "
          f"tokens in {res.ticks} ticks / {res.dispatches} decode "
          f"dispatches, {res.tokens_per_s:.1f} tok/s aggregate")
    if args.steps_per_tick > 1:
        dec_tok = n_tok - len(res.sessions)   # first tokens come from prefill
        hist = " ".join(f"K{k}:{v}" for k, v in sorted(res.horizon_hist.items()))
        print(f"horizon-K: steps_per_tick={args.steps_per_tick}, "
              f"{dec_tok / max(res.dispatches, 1):.1f} tokens per dispatch "
              f"({hist}), host dispatch {res.host_dispatch_s * 1e3:.1f} ms + "
              f"sync {res.host_sync_s * 1e3:.1f} ms over the run")
    if args.paged:
        from repro_torch.kernels.paged_decode_attention.ops import (
            serving_traffic_bytes)
        max_blocks = -(-max_len // args.page_size)
        full = 1 + args.slots * max_blocks
        pages = args.pages or full
        print(f"paged: page_size={args.page_size} pages={pages} "
              f"(full backing {full}, "
              f"oversubscription x{(full - 1) / max(pages - 1, 1):.2f}), "
              f"preemptions={res.preemptions}")
        if args.prefix_cache:
            # denominator = prefill work this run would have dispatched
            # without sharing (saved + dispatched)
            total = res.prefix_tokens_saved + res.prefill_tokens
            print(f"prefix cache: {res.prefix_hits} admission hits "
                  f"({len(reqs)} sessions), prefill tokens "
                  f"{res.prefill_tokens} dispatched / "
                  f"{res.prefix_tokens_saved} shared "
                  f"({res.prefix_tokens_saved / max(total, 1):.0%} of "
                  f"prefill work skipped), "
                  f"{res.cow_copies} CoW page cop"
                  f"{'y' if res.cow_copies == 1 else 'ies'}")
        if res.kv_tier != "none":
            print(f"kv tier ({res.tier_policy}): "
                  f"{res.pages_spilled} pages spilled / "
                  f"{res.pages_restored} restored, "
                  f"{res.tier_restores} parked-session restores, "
                  f"{res.host_prefix_hits} host prefix hits, "
                  f"{res.host_pages_used} host pages resident")
        if res.step_kv_blocks:
            tb = serving_traffic_bytes(res.step_kv_blocks, cfg,
                                       page_size=args.page_size,
                                       n_slots=args.slots,
                                       max_blocks=max_blocks,
                                       kv_quant=args.kv_quant)
            route = "fused-in-place" if backend == "cuda" else "gather+sdpa"
            moved = tb["fused"] if backend == "cuda" else tb["gather_sdpa"]
            quant_note = (f", kv_quant={args.kv_quant} "
                          f"floor {tb['floor'] / 1024:.1f} KiB"
                          if args.kv_quant != "none" else "")
            print(f"per-step KV traffic ({route}): {moved / 1024:.1f} KiB "
                  f"(fused would move {tb['fused'] / 1024:.1f}, gather "
                  f"{tb['gather_sdpa'] / 1024:.1f}{quant_note})")
    if args.quant != "bf16" or args.kv_quant != "none":
        from repro_torch.quant import tree_weight_traffic
        wb = tree_weight_traffic(engine.params)
        print(f"quantised serving: weights={args.quant} "
              f"kv={args.kv_quant}; per-step weight stream "
              f"{wb / 1024:.1f} KiB")
    if args.dispatch != "full_jit":
        captured = f"run by the {args.dispatch} executor"
    elif res.step_cache_size is not None:
        captured = f"captured as {res.step_cache_size} CUDA graph(s)"
    else:
        captured = "run as plain calls (no graph capture on the CPU)"
    print(f"decode step {captured}, {res.launches_per_step} host launch(es) "
          f"per step")
    if args.timed:
        for sid, s in res.sessions.items():
            if not s.step_times_s:
                continue
            p50 = float(np.median(s.step_times_s)) * 1e3
            p95 = float(np.percentile(s.step_times_s, 95)) * 1e3
            print(f"  {sid}: {len(s.tokens)} tokens, slot {s.slot}, "
                  f"ticks {s.admitted_tick}-{s.finished_tick}, "
                  f"step p50 {p50:.2f} ms p95 {p95:.2f} ms")
    first = next(iter(res.sessions.values()))
    print("first session tokens:", first.tokens[:12].tolist())
    return res


if __name__ == "__main__":
    main()
