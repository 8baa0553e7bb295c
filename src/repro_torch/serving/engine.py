"""Batch-1 / batched streaming decode engine — the paper's workload.

Port of ``repro.serving.engine``.  As in the reference, the decode step
is one program: on the card the engine captures ``Model.decode_step`` as
one CUDA graph (the paper's own conclusion, and the ``full_jit`` arm of
``core/dispatch.py``) and replays it per token.  Generation runs one of
two loops:

  step-streamed — one graph replay per token, sampling after it on the
                  host's side of the graph (what a Python serving loop
                  does; pays one launch per token)
  fused-loop    — ``Model.decode_steps`` over all N tokens with greedy
                  or temperature / top-k sampling on the device,
                  captured as one graph, the tokens read back once at
                  the end

and ``generate_continuous`` serves many sessions through the
continuous-batching scheduler (serving/scheduler.py).  For the dispatch
A/B, ``step_program`` opens the same step up to the ``eager`` and
``stage_jit`` executors.

Graphs are captured once per (batch, max_len, KV dtype, loop, horizon)
(the fused loop's also per temperature and top-k, which its graph
holds), as ``jax.jit`` keeps one executable per shape, each by a ``full_jit``
executor of ``core/dispatch.py``: the generation loops prefill
into one preallocated cache per (batch, max_len, KV dtype), in place
(rows past ``pos`` are masked; ssm state and conv windows are
overwritten).  The executor runs the first step of each shape eagerly
on a side stream (a real step, which makes the kernels' first-call
allocations outside capture) and captures the graph right after it;
capture runs nothing.  Prefill stays per op: its shapes change with every prompt
length, and a 2048-token prefill keeps the card busy on its own.  On the
CPU nothing is captured and every call is plain.

A stochastic fused graph draws from the one generator its executor
keeps, registered with the graph at capture; each call reseeds it
before the first token is drawn, so a replay draws what the same calls
draw uncaptured from that seed.

Everything runs under ``torch.inference_mode()``; tokens stay on the
device between steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dispatch import StepProgram
from repro_torch.models.model import Model
from repro_torch.quant import quantize_tree
from repro_torch.serving.sampling import sample


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # (B, n_new), or (B, n_new, K) with codebooks
    step_times_s: List[float]     # per-token wall times (step-streamed, timed)
    tokens_per_s: float


class DecodeEngine:
    def __init__(self, model: Model, params, *, quant_path: str = "bf16",
                 kv_dtype=None):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.device = model.device
        with torch.inference_mode():
            self.params = (quantize_tree(params, quant_path)
                           if quant_path != "bf16" else params)
        self.quant_path = quant_path
        self.kv_dtype = kv_dtype      # torch.int8: int8 KV codes + scales
        self._caches: Dict[tuple, dict] = {}    # (B, max_len, kv_dtype) -> cache
        self._executors: Dict[tuple, object] = {}   # cache key + (loop, horizon)
        self._generators: Dict[tuple, torch.Generator] = {}   # executor key

    # -------------------------------------------------------------- API
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def new_cache(self, batch: int, max_len: int):
        return self.model.init_cache(batch, max_len, kv_dtype=self.kv_dtype)

    @torch.inference_mode()
    def prefill(self, batch: Dict, max_len: int):
        """Prefill into a new cache; returns (last-position logits, cache)."""
        B = next(iter(batch.values())).shape[0]
        cache = self.new_cache(B, max_len)
        return self.model.prefill(self.params, batch, cache)

    def _prefill_reused(self, batch: Dict, max_len: int):
        """Prefill into this shape's own cache, in place, so that the
        shape's graphs find it at the addresses they were captured at.
        Returns (logits, cache key)."""
        B = next(iter(batch.values())).shape[0]
        key = (B, max_len, self.kv_dtype)
        if key not in self._caches:
            self._caches[key] = self.new_cache(B, max_len)
        logits, _ = self.model.prefill(self.params, batch, self._caches[key])
        return logits, key

    def decode_stage(self, state: Dict) -> Dict:
        """One decode step over ``state["cache"]``: {"logits"}."""
        return {"logits": self.model.decode_step(self.params, state["cache"],
                                                 state["tokens"])[0]}

    def _steps_stage(self, state: Dict) -> Dict:
        """``state["horizon"]`` steps with sampling on the device: {"out"},
        the (B, horizon) tokens."""
        return {"out": self.model.decode_steps(
            self.params, state["cache"], state["tokens"], state["gen"],
            horizon=state["horizon"], temperature=state["temperature"],
            top_k=state["top_k"])[0]}

    def _run(self, key, stage, state: Dict) -> Dict:
        """``stage(state)`` through the ``full_jit`` executor of ``key``:
        on the card its graph is captured at the key's first call and
        replayed after; plain calls off the card."""
        run = self._executors.get(key)
        if run is None:
            run = self._executors[key] = StepProgram([stage]).executor("full_jit")
        return run(state)

    def _token_shape(self, ids: torch.Tensor) -> torch.Tensor:
        """Sampled ids as the next step's tokens: (B,) -> (B, 1), and
        (B, K) audio codebooks -> (B, 1, K)."""
        if self.cfg.n_codebooks and ids.dim() == 2:
            return ids[:, None, :]
        if ids.dim() == 1:
            return ids[:, None]
        return ids

    def _generator(self, key: tuple, seed: int) -> torch.Generator:
        """The generator kept for executor ``key``, reseeded with
        ``seed``: a graph that draws keeps drawing from the generator it
        was captured with."""
        if key not in self._generators:
            self._generators[key] = torch.Generator(device=self.device)
        return self._generators[key].manual_seed(seed)

    @torch.inference_mode()
    # staticcheck: hotpath
    def generate_streamed(self, batch: Dict, *, max_len: int, n_new: int,
                          temperature: float = 0.0, top_k: int = 0,
                          seed: int = 0, timed: bool = False) -> GenerationResult:
        """One step per token (the paper's streaming workload): one graph
        replay on the card, then sampling.

        The generation wall is always timed (``tokens_per_s`` is real
        whether or not per-step instrumentation is on); ``timed=True``
        additionally synchronises after every step to record per-step
        walls for percentile reporting."""
        logits, key = self._prefill_reused(batch, max_len)
        cache = self._caches[key]
        gen = self._generator(key + ("step",), seed)
        out, times = [], []
        tok = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        out.append(tok)
        self._sync()
        t_gen = time.perf_counter()
        for _ in range(n_new - 1):
            t0 = time.perf_counter()
            logits = self._run(key + ("step",), self.decode_stage,
                               {"tokens": self._token_shape(tok),
                                "cache": cache})["logits"]
            tok = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
            if timed:
                self._sync()
                times.append(time.perf_counter() - t0)
            out.append(tok)
        self._sync()
        wall = time.perf_counter() - t_gen
        tokens = torch.stack(out, dim=1)
        tps = (n_new - 1) / wall if n_new > 1 and wall > 0 else float("nan")
        return GenerationResult(tokens, times, tps)

    @torch.inference_mode()
    def generate_fused(self, batch: Dict, *, max_len: int, n_new: int,
                       seed: int = 0, temperature: float = 0.0,
                       top_k: int = 0) -> GenerationResult:
        """N tokens through ``Model.decode_steps``: sampling on the device
        and one read-back of the token matrix at the end; on the card the
        N-1 steps are one graph replay, per (temperature, top_k) as well
        as shape.  A stochastic graph draws from its executor's generator,
        reseeded with ``seed`` here."""
        logits, key = self._prefill_reused(batch, max_len)
        cache = self._caches[key]
        horizon = n_new - 1
        run_key = key + ("steps", horizon, temperature, top_k)
        gen = self._generator(run_key, seed) if temperature > 0.0 else None
        tok0 = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        state = {"tokens": self._token_shape(tok0), "cache": cache, "gen": gen,
                 "horizon": horizon, "temperature": temperature, "top_k": top_k}
        self._sync()
        t0 = time.perf_counter()
        toks = self._run(run_key, self._steps_stage, state)["out"]
        self._sync()
        dt = time.perf_counter() - t0
        tokens = torch.cat([self._token_shape(tok0), toks], dim=1)
        tps = (n_new - 1) / dt if n_new > 1 and dt > 0 else float("nan")
        return GenerationResult(tokens, [], tps)

    def generate_continuous(self, sessions, *, n_slots: int, max_len: int,
                            temperature: float = 0.0, top_k: int = 0,
                            seed: int = 0, dispatch_mode: str = "full_jit",
                            paged: bool = False, page_size: int = 16,
                            n_pages: Optional[int] = None,
                            prefill_chunk: Optional[int] = None,
                            steps_per_tick: int = 1,
                            eos_id: Optional[int] = None, timed: bool = True,
                            prefix_cache: bool = False,
                            adaptive_k: bool = False,
                            min_steps_per_tick: int = 1,
                            priority_preemption: bool = True,
                            virtual_step_s: float = 1e-3,
                            virtual_dispatch_s: float = 4e-3,
                            shared_programs: bool = False,
                            kv_tier: str = "none",
                            tier_policy="spill",
                            host_pages: Optional[int] = None,
                            virtual_host_copy_s: float = 5e-4,
                            fault_injector=None,
                            retry_budget: int = 2,
                            session_ttl_s: Optional[float] = None,
                            restore_patience: int = 0,
                            quarantine_budget: int = 2,
                            self_audit: bool = False,
                            logit_screen: Optional[bool] = None):
        """Continuous batching: serve ``sessions`` (SessionRequest list)
        through a fixed number of cache slots — admission, per-slot
        prefill, shared batched decode, eviction, FIFO backfill.
        ``paged=True`` serves out of a page pool with per-slot block
        tables (``n_pages`` below full backing oversubscribes it,
        ``prefill_chunk`` admits long prompts chunk by chunk between
        decode ticks, ``prefix_cache`` shares page-aligned prompt
        prefixes through copy-on-write pages).  ``steps_per_tick=K > 1``
        fuses K decode steps into one macro-tick with on-device sampling
        (``adaptive_k`` picks K per tick from the halving ladder down to
        ``min_steps_per_tick``); ``eos_id`` ends sessions early.  On the
        card each decode program is one captured CUDA graph per (route,
        K).  The engine's ``kv_dtype`` selects int8 KV.

        Requests with ``arrival_s > 0`` are replayed: released by virtual
        arrival time against the scheduler's clock (``virtual_step_s`` a
        device decode step, ``virtual_dispatch_s`` a dispatched program;
        serving/trace.py builds traces and scores the SLO metrics);
        ``priority_preemption=False`` evicts youngest-first.
        ``kv_tier='host'`` (paged only) parks preempted sessions' full
        pages in host DRAM and restores them on re-admission, and gives
        LRU-evicted prefix pages a host prefix index — placement by
        ``tier_policy`` (prefer-device | spill | lookahead), capacity
        ``host_pages``, virtual cost ``virtual_host_copy_s`` a page.
        ``fault_injector`` (serving/faults.py) arms a seeded fault plan:
        copy failures retry (``retry_budget``) then degrade to
        re-prefill, poisoned logits quarantine their lane
        (``quarantine_budget`` requeues, then fail-closed), aborts and
        ``session_ttl_s`` end a session with a terminal status,
        ``self_audit`` checks the page accounting on idle ticks, and
        ``restore_patience`` holds a parked copy that many ticks before
        re-prefill supersedes it.  ``shared_programs`` is accepted for
        the reference's API; each scheduler captures its own graphs.
        Returns a ``ContinuousResult``."""
        from repro_torch.serving.scheduler import SlotScheduler
        sched = SlotScheduler(self.model, self.params, n_slots=n_slots,
                              max_len=max_len, dispatch_mode=dispatch_mode,
                              temperature=temperature, top_k=top_k,
                              seed=seed, kv_dtype=self.kv_dtype,
                              paged=paged, page_size=page_size,
                              n_pages=n_pages, prefill_chunk=prefill_chunk,
                              steps_per_tick=steps_per_tick, eos_id=eos_id,
                              timed=timed, prefix_cache=prefix_cache,
                              adaptive_k=adaptive_k,
                              min_steps_per_tick=min_steps_per_tick,
                              priority_preemption=priority_preemption,
                              virtual_step_s=virtual_step_s,
                              virtual_dispatch_s=virtual_dispatch_s,
                              shared_programs=shared_programs,
                              kv_tier=kv_tier, tier_policy=tier_policy,
                              host_pages=host_pages,
                              virtual_host_copy_s=virtual_host_copy_s,
                              fault_injector=fault_injector,
                              retry_budget=retry_budget,
                              session_ttl_s=session_ttl_s,
                              restore_patience=restore_patience,
                              quarantine_budget=quarantine_budget,
                              self_audit=self_audit,
                              logit_screen=logit_screen)
        for req in sessions:
            sched.submit(req)
        return sched.run()

    # ------------------------------------------------- dispatch A/B hooks
    def step_program(self, cache) -> StepProgram:
        return self.model.step_program(self.params, cache)
