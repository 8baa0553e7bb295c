"""The paper's measurement protocol (§3.1, App D), as reusable machinery.

Port of ``repro.core.protocol``.  A *cell* = one configuration measured
as: 5 warmup steps + 30 measured steps, report the median
(within-session).  A *session* = a fresh environment.  The paper starts
a fresh container per session; the reference clears JAX's compilation
caches.  Here ``run_ab`` drops the previous session's step functions
(and with them their executors, graphs and graph pools), collects them
and empties the CUDA caching allocator, and the caller's ``make_*``
builds new executors over a new cache.  Sessions may share weights drawn
once, as the paper's containers load one checkpoint.  N sessions give
the cross-session replication with a bootstrap CI on the mean paired
speedup.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import stats

WARMUP_STEPS = 5
MEASURED_STEPS = 30


@dataclasses.dataclass
class CellResult:
    name: str
    step_times_s: List[float]
    meta: Dict

    @property
    def p50_s(self) -> float:
        return stats.p50(self.step_times_s)

    @property
    def p50_ms(self) -> float:
        return self.p50_s * 1e3

    @property
    def within_cv(self) -> float:
        return stats.cv(self.step_times_s)

    def to_json(self) -> Dict:
        return {"name": self.name, "p50_ms": self.p50_ms,
                "step_times_ms": [t * 1e3 for t in self.step_times_s],
                "within_cv": self.within_cv, **self.meta}


def _devices(x):
    """The CUDA devices of the tensors in ``x`` (a tensor, or dicts,
    lists and tuples of them)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_devices(v) for v in x))
    return set()


def _block(x):
    """Wait until the card has computed ``x``; nothing to wait for on the
    CPU."""
    for device in _devices(x):
        torch.cuda.synchronize(device)
    return x


def measure_cell(step_fn: Callable[[], object], *, name: str = "cell",
                 warmup: int = WARMUP_STEPS, steps: int = MEASURED_STEPS,
                 meta: Optional[Dict] = None) -> CellResult:
    """5 warmup + 30 measured single steps, wall-clock each, paper-style.

    ``step_fn`` must carry its own state (closure) and return the
    tensors (or a dict of them) we wait on.
    """
    for _ in range(warmup):
        _block(step_fn())
    times: List[float] = []
    for _ in range(steps):
        t0 = time.perf_counter()
        _block(step_fn())
        times.append(time.perf_counter() - t0)
    return CellResult(name, times, dict(meta or {}, warmup=warmup, steps=steps))


@dataclasses.dataclass
class ABResult:
    """Within-session paired A/B across N sessions (paper Table 2)."""
    name: str
    baseline_p50s: List[float]     # seconds, one per session
    treated_p50s: List[float]

    @property
    def speedups(self):
        return stats.paired_speedups(self.baseline_p50s, self.treated_p50s)

    def summary(self) -> Dict:
        sp = self.speedups
        lo, hi = stats.bootstrap_ci_mean(sp)
        return {
            "name": self.name,
            "n_sessions": len(self.baseline_p50s),
            "baseline_mean_ms": stats.mean(self.baseline_p50s) * 1e3,
            "baseline_cv": stats.cv(self.baseline_p50s),
            "treated_mean_ms": stats.mean(self.treated_p50s) * 1e3,
            "treated_cv": stats.cv(self.treated_p50s),
            "mean_speedup": stats.mean(sp),
            "speedup_std": stats.std(sp),
            "speedup_cv": stats.cv(sp),
            "speedup_ci95": [lo, hi],
            "per_session": [
                {"baseline_ms": b * 1e3, "treated_ms": t * 1e3, "speedup": float(s)}
                for b, t, s in zip(self.baseline_p50s, self.treated_p50s, sp)
            ],
        }


def _fresh_session() -> None:
    """Stand-in for the paper's fresh container: collect what the last
    session dropped (its executors, graphs and graph pools) and hand the
    cached device memory back."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_ab(make_baseline: Callable[[int], Callable[[], object]],
           make_treated: Callable[[int], Callable[[], object]],
           *, n_sessions: int = 10, name: str = "ab",
           warmup: int = WARMUP_STEPS, steps: int = MEASURED_STEPS,
           fresh_session: bool = True) -> ABResult:
    """Paper §5 protocol: per session, run baseline arm then treated arm
    (within-session A/B), p50 each; pair the ratios across sessions.

    ``make_*`` take the session index (used as seed) and return a step
    fn; each is dropped after its arm.
    """
    base_p50s, treat_p50s = [], []
    for s in range(n_sessions):
        if fresh_session:
            _fresh_session()
        b = measure_cell(make_baseline(s), name=f"{name}/s{s}/baseline",
                         warmup=warmup, steps=steps)
        t = measure_cell(make_treated(s), name=f"{name}/s{s}/treated",
                         warmup=warmup, steps=steps)
        base_p50s.append(b.p50_s)
        treat_p50s.append(t.p50_s)
    return ABResult(name, base_p50s, treat_p50s)
