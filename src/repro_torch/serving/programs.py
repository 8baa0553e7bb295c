"""The programs the continuous-batching scheduler dispatches.

Port of ``repro.serving.programs``.  The reference jit-compiles each
program; here prefill (whole-prompt or chunked) and the copy-on-write
page copy are plain calls, and the decode step — K=1 (``step``) or a
horizon-K macro-tick (``steps``) — is, on the card, a CUDA graph
captured once per (route, K, params, sampling) at first use and replayed
after that.  The graph reads its tokens and lane budgets from static
input buffers and the cache, block table and positions at their fixed
addresses, which the scheduler updates in place.  On a CPU model every
program is a plain call.  A stochastic horizon-K graph draws from the
scheduler's generator, registered with each K's graph at capture, so the
replays draw what the same ticks draw uncaptured; the K=1 step samples
outside its graph.

The capture helpers and the launch tallies (``captured_launches``,
``replay_launches``) are ``core/dispatch.py``'s, shared with the engine
and the dispatch A/B executors.  Under the ``eager`` and ``stage_jit``
arms the scheduler runs its ``StepProgram`` executor instead of ``step``,
as the reference leaves ``step`` unbuilt under them.

With the host KV tier, ``save_pages`` and ``restore_pages`` gather pages
out of the pools and write them back in place (``Model.save_kv_pages``,
``restore_kv_pages``): plain calls between graph replays, never
captured.

``shared_programs``: callers that build many schedulers over one model
(an A/B sweep's arms) would capture every graph again in each arm.  The
reference shares its jit wrappers, which take the cache as an argument;
a CUDA graph instead bakes in the addresses of all it reads — the cache,
the params, its static inputs and its registered generator.  So with the
flag the model keeps one ``_Shared`` entry per cache signature (slots,
max_len, KV dtype, paged, page size, pages): the cache the first
scheduler of that signature allocated, one generator, and the graphs
captured over them, keyed by route, K, the params (by identity; the
entry holds them, so an id is never reused) and the sampling setting.  A
later scheduler zeroes that cache in place, reseeds the generator, and
replays the graphs it finds.  The entry serves one scheduler at a time:
the newest takes it, and an older one raises on its next device call.
Entries live as long as the model, one cache for each signature served
over it; drop the model to give their memory back.  The scheduler's
``step_cache_size()`` reports the graphs captured since it was built.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.dispatch import (_Captured, capture, captured_launches,  # noqa: F401
                                       replay_launches, warm_up)
from repro_torch.models.model import Model


class _Shared:
    """What the schedulers over one model and one cache signature share:
    the cache, the generator, the captured graphs, the params the graph
    keys name, and the newest ``SchedulerPrograms`` to take them."""

    def __init__(self, cache: Dict[str, torch.Tensor], device: torch.device):
        self.cache = cache
        self.gen = torch.Generator(device=device)
        self.graphs: Dict[tuple, _Captured] = {}
        self.params: Dict[int, Any] = {}
        self.owner: Optional[SchedulerPrograms] = None


class SchedulerPrograms:
    """The decode and prefill programs of one ``SlotScheduler``.

    ``prefill_chunk``/``copy_page`` exist only paged, ``save_pages``/
    ``restore_pages`` only with the host KV tier, ``prefill_slot`` only
    contiguous.  ``step``/``steps`` return (logits, cache) and
    (token matrix, cache); on the card the returned tensor is the
    graph's static output, overwritten by the next replay.  With
    ``shared_programs`` every program first checks that this instance
    still owns its entry (``adopt``)."""

    def __init__(self, model: Model, *, paged: bool, kv_tier: str = "none",
                 shared_programs: bool = False):
        self.model = model
        self.capture = model.device.type == "cuda"
        self._store: Optional[Dict[tuple, _Shared]] = (
            model.__dict__.setdefault("_shared_sched_programs", {})
            if shared_programs else None)
        self._entry: Optional[_Shared] = None
        guard = self._guarded
        self.prefill_chunk = guard(model.prefill_chunk_into_slot if paged else None)
        self.copy_page = guard(model.copy_kv_page if paged else None)
        self.prefill_slot = guard(None if paged else model.prefill_into_slot)
        tiered = paged and kv_tier == "host"
        self.save_pages = guard(model.save_kv_pages if tiered else None)
        self.restore_pages = guard(model.restore_kv_pages if tiered else None)
        self._graphs: Dict[tuple, _Captured] = {}

    def _guarded(self, fn: Optional[Callable]) -> Optional[Callable]:
        if fn is None or self._store is None:
            return fn

        @functools.wraps(fn)
        def call(*args, **kwargs):
            self.check_owner()
            return fn(*args, **kwargs)
        return call

    def adopt(self, signature: tuple, make_cache: Callable[[], Dict[str, torch.Tensor]],
              seed: int):
        """(cache, generator seeded with ``seed``) to serve from.
        Unshared: ``make_cache()`` and a generator of this instance's own.
        Shared: the entry for ``signature``, made with ``make_cache()``
        the first time; a later scheduler zeroes its every tensor in
        place (``init_cache``'s state: the graphs read these addresses),
        reseeds its generator (registered with the horizon graphs, which
        read its seed and offset at each replay) and takes the entry over
        from the scheduler before it."""
        dev = self.model.device
        if self._store is None:
            cache, gen = make_cache(), torch.Generator(device=dev)
        else:
            entry = self._store.get(signature)
            if entry is None:
                entry = self._store[signature] = _Shared(make_cache(), dev)
            else:
                for t in entry.cache.values():
                    t.zero_()
            entry.owner = self
            self._entry = entry
            self._graphs = entry.graphs
            cache, gen = entry.cache, entry.gen
        return cache, gen.manual_seed(seed)

    def check_owner(self) -> None:
        """Raise if a newer scheduler took this instance's shared entry:
        its cache now holds the newer scheduler's sessions."""
        if self._entry is not None and self._entry.owner is not self:
            raise RuntimeError(
                "a newer scheduler over this model took this scheduler's shared "
                "cache and graphs (shared_programs=True); only the newest "
                "scheduler of a cache signature may run")

    def _key(self, params, horizon: int, *sampling) -> tuple:
        """What a capture bakes in besides the cache: the route, K, the
        params and (horizon-K) the sampling setting."""
        if self._entry is not None:
            self._entry.params[id(params)] = params
        return (self.model.decode_backend, horizon, id(params)) + sampling

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
        self.check_owner()
        model = self.model
        if not self.capture:
            return model.decode_step(params, cache,
                                     tokens.to(model.device, non_blocking=True))
        key = self._key(params, 1)
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
        self.check_owner()
        model = self.model
        kw = dict(horizon=horizon, temperature=temperature, top_k=top_k,
                  eos_id=eos_id)
        if not self.capture:
            return model.decode_steps(
                params, cache, tokens.to(model.device, non_blocking=True), gen,
                steps_left.to(model.device, non_blocking=True), **kw)
        key = self._key(params, horizon, temperature, top_k, eos_id)
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
        """CUDA graphs in the store this instance reads (its own, or its
        shared entry's); None off the card, where nothing is captured."""
        return len(self._graphs) if self.capture else None
