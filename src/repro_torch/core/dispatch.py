"""Dispatch-mode executors: the paper's CUDA-Graphs A/B (§5) on the card.

Port of ``repro.core.dispatch``.  The same decode step runs as

  eager     — ``compose()`` called as plain Python: one host launch per
              op (the paper's eager PyTorch arm)
  stage_jit — one CUDA graph per stage (embedding / decoder block /
              head), replayed in order by a host loop; each stage reads
              the previous graph's static output
  full_jit  — the composed step captured once as one CUDA graph (the
              paper's CUDA-Graphs arm)

``StepProgram`` decomposes a step into stages so that all three
executors run the same kernels on the same inputs; only the launch
schedule differs.  On a CPU cache every arm is a plain call of
``compose()``: nothing is captured off the card.

A graph executor captures at its first call, against the cache of that
call: it runs the step once eagerly on a side stream (a real step, which
also makes the kernels' first-call allocations outside capture), then
records the graphs, which executes nothing.  Later calls must pass the
same cache (the same tensors at the same addresses) and raise otherwise,
since a replay writes where the capture saw the cache.  A state that
carries a generator (``"gen"``: the engine's fused loop draws from it)
has it registered with each graph, and later calls must pass that same
generator.

The capture helpers (``warm_up``, ``capture``, ``_Captured``) serve the
engine, the scheduler and the executors alike.  A replay launches the
kernels its capture recorded without calling their wrappers, so the
wrappers' ``launches`` counters see the capture only.
``captured_launches`` and ``replay_launches`` keep the other two terms,
by kernel name: what the captures recorded (counted by the wrappers but
not launched) and what the replays launched.  The kernels launched on
the card are ``launches - captured_launches + replay_launches``.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.kernels import launch_counts

Stage = Callable[[Any], Any]   # state dict -> state dict

MODES = ("eager", "stage_jit", "full_jit")

captured_launches: Dict[str, int] = {}
replay_launches: Dict[str, int] = {}


def _tally(counter: Dict[str, int], launches: Dict[str, int]) -> None:
    for name, n in launches.items():
        counter[name] = counter.get(name, 0) + n


class _Captured:
    """One captured program: its graph, static inputs, output and the
    kernel launches (by kernel name) that one replay makes."""

    def __init__(self, graph, inputs: Dict[str, torch.Tensor], output,
                 launches: Dict[str, int]):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        _tally(replay_launches, self.launches)


def warm_up(fn: Callable[[], Any], device: torch.device) -> Any:
    """``fn()`` on a side stream joined to the current one before and
    after (torch's recipe before a capture: lazy allocations such as
    cuBLAS workspaces and the kernels' tickets are made outside it)."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def capture(fn: Callable[[], Any], inputs: Dict[str, torch.Tensor], *,
            pool=None, generators: Sequence[torch.Generator] = ()) -> _Captured:
    """Record ``fn()`` as one CUDA graph on its static ``inputs`` (into
    ``pool`` when given: graphs replayed in the order they were captured
    may share one).  Capture records the launches without running them.

    ``generators`` are the generators ``fn`` draws from.  Each is
    registered with the graph before capture: capture leaves it where it
    was, and each replay draws at its offset then and advances it by the
    graph's draws, so a replay draws what the same calls draw uncaptured.
    A generator drawn from but not registered makes the capture raise.

    Reference cycles are collected first and the collector is off
    during capture: a cycle freed inside it (a scheduler and its host
    tier's page-locked rows, say) would make CUDA calls that a capture
    forbids, and the capture would fail."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = launch_counts()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            output = fn()
    finally:
        if enabled:
            gc.enable()
    launches = {name: n - before[name] for name, n in launch_counts().items()
                if n != before[name]}
    _tally(captured_launches, launches)
    return _Captured(graph, inputs, output, launches)


def _addresses(cache: Dict[str, torch.Tensor]) -> tuple:
    return tuple((key, t.data_ptr()) for key, t in cache.items())


class _GraphExecutor:
    """The stage_jit / full_jit arm: one CUDA graph per entry of
    ``stages`` on the card, captured at the first call; plain calls of
    the stages off it."""

    def __init__(self, stages: List[Stage]):
        self.stages = stages
        self._graphs: Optional[List[_Captured]] = None

    def _plain(self, state):
        for st in self.stages:
            state = st(state)
        return state

    def _capture(self, state):
        cache = state["cache"]
        device = cache["pos"].device
        out = warm_up(lambda: self._plain(state), device)   # the real step
        tokens = state["tokens"].clone()
        static = dict(state, tokens=tokens)
        pool = torch.cuda.graph_pool_handle()
        self._gen = state.get("gen")
        gens = () if self._gen is None else (self._gen,)
        graphs = []
        for st in self.stages:
            cap = capture(lambda st=st, s=static: st(s), {"tokens": tokens},
                          pool=pool, generators=gens)
            graphs.append(cap)
            static = cap.output
        self._addresses = _addresses(cache)
        self._out = static
        self._graphs = graphs
        return out

    # staticcheck: hotpath
    def __call__(self, state):
        cache = state["cache"]
        with torch.inference_mode():
            if cache["pos"].device.type != "cuda":
                return self._plain(state)
            if self._graphs is None:
                return self._capture(state)
            tokens = self._graphs[0].inputs["tokens"]
            if (_addresses(cache) != self._addresses
                    or state["tokens"].shape != tokens.shape
                    or state.get("gen") is not self._gen):
                raise ValueError("this executor's graphs were captured against "
                                 "another cache, token shape or generator; "
                                 "build an executor for this one")
            tokens.copy_(state["tokens"])
            for g in self._graphs:
                g.replay()
            return dict(self._out, tokens=state["tokens"], cache=cache)


@dataclasses.dataclass
class StepProgram:
    """A step decomposed into sequential stages over a carried state."""
    stages: List[Stage]

    def compose(self) -> Stage:
        def full(state):
            for st in self.stages:
                state = st(state)
            return state
        return full

    def executor(self, mode: str) -> Stage:
        """Build a callable state->state for the given dispatch mode."""
        if mode == "eager":
            step = self.compose()

            def run(state):
                with torch.inference_mode():
                    return step(state)
            return run
        if mode == "stage_jit":
            return _GraphExecutor(list(self.stages))
        if mode == "full_jit":
            return _GraphExecutor([self.compose()])
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    def launch_count(self, mode: str) -> int:
        """Host-dispatch count per step for ``mode`` (method form of the
        module-level ``launch_count``)."""
        return launch_count(self, mode)


def launch_count(program: StepProgram, mode: str) -> int:
    """Host launches per step (the paper's ~283-launch anchor, App D).

    eager: one per op (not known statically; returns -1), stage_jit: one
    graph per stage, full_jit: 1.
    """
    if mode == "eager":
        return -1
    if mode == "stage_jit":
        return len(program.stages)
    if mode == "full_jit":
        return 1
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
