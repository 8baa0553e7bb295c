"""The programs the continuous-batching scheduler dispatches.

Port of ``repro.serving.programs``.  The reference jit-compiles each
program; here prefill (whole-prompt or chunked) and the copy-on-write
page copy are plain calls, and the decode step — K=1 (``step``) or a
horizon-K macro-tick (``steps``) — is, on the card, a CUDA graph
captured once per (route, K) at first use and replayed after that.  The
graph reads its tokens and lane budgets from static input buffers and
the cache, block table and positions at their fixed addresses, which the
scheduler updates in place.  On a CPU model every program is a plain
call.  A stochastic horizon-K graph draws from the scheduler's generator,
registered with each K's graph at capture, so the replays draw what the
same ticks draw uncaptured; the K=1 step samples outside its graph.

The capture helpers and the launch tallies (``captured_launches``,
``replay_launches``) are ``core/dispatch.py``'s, shared with the engine
and the dispatch A/B executors.  Under the ``eager`` and ``stage_jit``
arms the scheduler runs its ``StepProgram`` executor instead of ``step``,
as the reference leaves ``step`` unbuilt under them.

With the host KV tier, ``save_pages`` and ``restore_pages`` gather pages
out of the pools and write them back in place (``Model.save_kv_pages``,
``restore_kv_pages``): plain calls between graph replays, never
captured.  The reference's ``shared_programs`` shares jit wrappers
across schedulers over one model; a captured graph reads its own
cache's addresses, so here each scheduler keeps its own programs (the
scheduler accepts the flag for API parity).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.dispatch import (_Captured, capture, captured_launches,  # noqa: F401
                                       replay_launches, warm_up)
from repro_torch.models.model import Model


class SchedulerPrograms:
    """The decode and prefill programs of one ``SlotScheduler``.

    ``prefill_chunk``/``copy_page`` exist only paged, ``save_pages``/
    ``restore_pages`` only with the host KV tier, ``prefill_slot`` only
    contiguous.  ``step``/``steps`` return (logits, cache) and
    (token matrix, cache); on the card the returned tensor is the
    graph's static output, overwritten by the next replay."""

    def __init__(self, model: Model, *, paged: bool, kv_tier: str = "none"):
        self.model = model
        self.capture = model.device.type == "cuda"
        self.prefill_chunk = model.prefill_chunk_into_slot if paged else None
        self.copy_page = model.copy_kv_page if paged else None
        self.prefill_slot = None if paged else model.prefill_into_slot
        tiered = paged and kv_tier == "host"
        self.save_pages = model.save_kv_pages if tiered else None
        self.restore_pages = model.restore_kv_pages if tiered else None
        self._graphs: Dict[tuple, _Captured] = {}

    def _capture(self, key, inputs: Dict[str, torch.Tensor], warm,
                 run, gen: Optional[torch.Generator] = None) -> _Captured:
        """Warm the program up on a side stream with every lane inactive
        (state-preserving: no position moves, writes go to the garbage
        page or rewrite the old row), then capture ``run`` on the static
        ``inputs``, with ``gen`` (what ``run`` draws from) registered.
        Capture records the launches without running them."""
        warm_up(warm, self.model.device)
        self._graphs[key] = capture(run, inputs,
                                    generators=() if gen is None else (gen,))
        return self._graphs[key]

    def step(self, params, cache, tokens: torch.Tensor):
        """One decode step on every lane; tokens (B, 1) int32, on the
        card or page-locked (``core.dispatch.pinned_copy``), so that the
        copy into the graph's input does not make the host wait."""
        model = self.model
        if not self.capture:
            return model.decode_step(params, cache,
                                     tokens.to(model.device, non_blocking=True))
        key = (model.decode_backend, 1)
        prog = self._graphs.get(key)
        if prog is None:
            tok = torch.zeros_like(tokens, device=model.device)
            idle = torch.zeros((tok.shape[0],), dtype=torch.bool,
                               device=model.device)
            prog = self._capture(
                key, {"tokens": tok},
                lambda: model.decode_step(params, cache, tok, active=idle),
                lambda: model.decode_step(params, cache, tok)[0])
        prog.inputs["tokens"].copy_(tokens, non_blocking=True)
        prog.replay()
        return prog.output, cache

    def steps(self, params, cache, tokens: torch.Tensor,
              steps_left: torch.Tensor, gen: Optional[torch.Generator], *,
              horizon: int, temperature: float, top_k: int,
              eos_id: Optional[int]):
        """A horizon-K macro-tick: (B, horizon) sampled tokens, drawn
        from ``gen`` when ``temperature > 0``; ``tokens`` and
        ``steps_left`` as ``step``'s tokens.  The warm-up before a
        capture draws from a generator of its own, so ``gen`` moves only
        with the ticks, as uncaptured."""
        model = self.model
        kw = dict(horizon=horizon, temperature=temperature, top_k=top_k,
                  eos_id=eos_id)
        if not self.capture:
            return model.decode_steps(
                params, cache, tokens.to(model.device, non_blocking=True), gen,
                steps_left.to(model.device, non_blocking=True), **kw)
        key = (model.decode_backend, horizon)
        prog = self._graphs.get(key)
        if prog is None:
            tok = torch.zeros_like(tokens, device=model.device)
            left = torch.zeros_like(steps_left, device=model.device)
            draw = gen if temperature > 0.0 else None
            spare = None if draw is None else torch.Generator(device=model.device)
            prog = self._capture(
                key, {"tokens": tok, "steps_left": left},
                lambda: model.decode_steps(params, cache, tok, spare,
                                           torch.zeros_like(left), **kw),
                lambda: model.decode_steps(params, cache, tok, draw, left,
                                           **kw)[0], draw)
        prog.inputs["tokens"].copy_(tokens, non_blocking=True)
        prog.inputs["steps_left"].copy_(steps_left, non_blocking=True)
        prog.replay()
        return prog.output, cache

    def raw_step_cache_size(self) -> Optional[int]:
        """CUDA graphs captured (one per (route, K)); None off the card,
        where nothing is captured."""
        return len(self._graphs) if self.capture else None
