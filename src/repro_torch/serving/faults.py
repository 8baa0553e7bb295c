"""Seeded fault plans + the injector the scheduler consults.

The serving stack asserts every feature token-exactly against a
baseline; this module extends that discipline to *failures*.  A
``FaultPlan`` is a deterministic schedule of fault events on the same
virtual clock trace replay runs on — generated from one
``random.Random`` stream and serialised byte-stably exactly like
serving/trace.py traces — so a chaos run is as reproducible as a clean
one: the same ``(config, seed)`` pair regenerates the identical plan,
and replaying it reproduces the identical fault schedule, recovery
actions, and counters.

Fault kinds (``KINDS``) and where they bite:

  * ``save_fail`` / ``restore_fail`` — the next N host-tier page-copy
    calls (``save_kv_blobs`` / ``restore_kv_blobs``) raise
    ``InjectedFault``; the tier's bounded retry-with-backoff absorbs
    them or degrades to re-prefill (memory/tiers.py).
  * ``blob_corrupt`` — flip a byte of a parked host blob; the
    restore-time checksum screen must catch it and degrade.
  * ``pool_pressure`` — withhold pages from the device free list for a
    bounded virtual duration (a transient capacity spike).
  * ``nan_logits`` — poison one lane's sampled logits/tokens for one
    macro-tick; the scheduler's screen quarantines the session.
  * ``abort`` — a mid-stream client disconnect: the session is torn
    down wherever it lives and its slot/pages/blobs are freed.

The ``FaultInjector`` walks the plan against ``now_s``: copy-failure
specs arm consumable failure budgets (drawn by the tier's save/restore
wrappers), every other kind is returned from ``poll`` for the scheduler
to apply.  ``fired`` counts faults that actually landed — a spec whose
window finds nothing to break (nothing parked, nobody live) stays
unfired rather than corrupting an unrelated victim.

A copy of ``repro.serving.faults`` (the standard library only), held
equal in behaviour to it by ``tests/test_torch_serving_copies.py`` and
``tests/test_torch_faults.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

KINDS = ("save_fail", "restore_fail", "blob_corrupt", "pool_pressure",
         "nan_logits", "abort")

_FMT = "%.6f"                    # fixed-width times: byte-stable text


class InjectedFault(RuntimeError):
    """Raised by the tier's copy wrappers when an armed copy failure is
    consumed — indistinguishable from a real transport error to the
    retry machinery, which is the point."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault event on the virtual clock."""
    kind: str
    at_s: float                  # virtual due time
    target: str = ""             # session id ("" = any live session)
    count: int = 1               # copy fails to arm / blobs / pages
    duration_s: float = 0.0      # pool_pressure: hold time


@dataclasses.dataclass(frozen=True)
class FaultPlanConfig:
    """Everything that determines a plan, and nothing else."""
    seed: int = 7
    n_faults: int = 8
    horizon_s: float = 1.0       # events land uniformly in [0, horizon)
    kinds: Tuple[str, ...] = KINDS
    max_count: int = 3           # per-event count drawn from [1, max]
    max_duration_s: float = 0.05  # pool_pressure hold ceiling

    def __post_init__(self):
        assert self.n_faults >= 0 and self.horizon_s > 0
        assert self.max_count >= 1 and self.max_duration_s > 0
        assert self.kinds and all(k in KINDS for k in self.kinds)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    config: FaultPlanConfig
    specs: Tuple[FaultSpec, ...]


def generate_fault_plan(cfg: FaultPlanConfig,
                        session_ids: Sequence[str] = ()) -> FaultPlan:
    """Deterministically expand a config into a fault schedule.
    ``session_ids`` (e.g. the trace's) lets targeted kinds pick real
    victims; without them targets stay "" (= whoever is live)."""
    r = random.Random(cfg.seed)
    sids = tuple(session_ids)
    specs = []
    for _ in range(cfg.n_faults):
        kind = cfg.kinds[r.randrange(len(cfg.kinds))]
        at = round(r.random() * cfg.horizon_s, 6)
        count = 1 + r.randrange(cfg.max_count)
        dur = 0.0
        target = ""
        if kind == "pool_pressure":
            dur = round((0.2 + 0.8 * r.random()) * cfg.max_duration_s, 6)
        if kind in ("nan_logits", "abort"):
            if sids:
                target = sids[r.randrange(len(sids))]
            count = 1            # one victim per spec, always
        specs.append(FaultSpec(kind, at, target, count, dur))
    specs.sort(key=lambda s: (s.at_s, s.kind, s.target))
    plan = FaultPlan(cfg, tuple(specs))
    validate_plan(plan)
    return plan


def validate_plan(plan: FaultPlan) -> None:
    """Schema validity with explicit raises (a hand-edited plan file
    must fail loudly even under ``python -O``)."""
    def bad(msg: str) -> None:
        raise ValueError(f"invalid fault plan: {msg}")

    last = 0.0
    for spec in plan.specs:
        if spec.kind not in KINDS:
            bad(f"unknown kind {spec.kind!r}")
        if spec.at_s < 0:
            bad(f"{spec.kind}: negative due time {spec.at_s!r}")
        if spec.at_s < last:
            bad(f"{spec.kind}: specs must be time-sorted "
                f"({spec.at_s!r} after {last!r})")
        last = spec.at_s
        if spec.count < 1:
            bad(f"{spec.kind}: count {spec.count!r} must be >= 1")
        if spec.duration_s < 0:
            bad(f"{spec.kind}: negative duration {spec.duration_s!r}")
        if spec.kind == "pool_pressure" and spec.duration_s <= 0:
            bad("pool_pressure needs a positive hold duration")
        if " " in spec.target:
            bad(f"target {spec.target!r} must be a token")


# --------------------------------------------------------------- text I/O
def plan_to_text(plan: FaultPlan) -> str:
    """Serialise byte-stably: a header pinning the config, one line per
    scheduled fault ('-' encodes the empty any-session target)."""
    cfg = plan.config
    lines = [
        "# faultplan v1 seed=%d n=%d horizon=%s max_count=%d "
        "max_duration=%s kinds=%s"
        % (cfg.seed, cfg.n_faults, _FMT % cfg.horizon_s, cfg.max_count,
           _FMT % cfg.max_duration_s, ",".join(cfg.kinds))]
    for s in plan.specs:
        lines.append("%s t=%s target=%s count=%d dur=%s"
                     % (s.kind, _FMT % s.at_s, s.target or "-", s.count,
                        _FMT % s.duration_s))
    return "\n".join(lines) + "\n"


def plan_from_text(text: str) -> FaultPlan:
    """Parse ``plan_to_text`` output back into a plan (validated)."""
    header = None
    specs: List[FaultSpec] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        if parts[0] == "#" and parts[1] == "faultplan":
            assert parts[2] == "v1", f"unknown plan version {parts[2]}"
            header = dict(p.split("=", 1) for p in parts[3:])
        else:
            kv = dict(p.split("=", 1) for p in parts[1:])
            target = kv["target"]
            specs.append(FaultSpec(
                parts[0], at_s=float(kv["t"]),
                target="" if target == "-" else target,
                count=int(kv["count"]), duration_s=float(kv["dur"])))
    assert header is not None, "missing fault plan header"
    cfg = FaultPlanConfig(
        seed=int(header["seed"]), n_faults=int(header["n"]),
        horizon_s=float(header["horizon"]),
        kinds=tuple(header["kinds"].split(",")),
        max_count=int(header["max_count"]),
        max_duration_s=float(header["max_duration"]))
    plan = FaultPlan(cfg, tuple(specs))
    validate_plan(plan)
    return plan


# ---------------------------------------------------------------- injector
class FaultInjector:
    """Walks a plan against the scheduler's virtual clock.

    ``poll(now_s)`` activates every spec now due: copy-failure specs
    arm the consumable ``save_fails`` / ``restore_fails`` budgets that
    the tier's guarded copy wrappers draw from (``take_copy_fail``);
    all other kinds are returned for the scheduler to apply in place.
    ``fired`` counts faults that actually landed — compare two runs'
    ``counters()`` for byte-exact chaos reproducibility."""

    def __init__(self, plan: FaultPlan):
        validate_plan(plan)
        self.plan = plan
        self._idx = 0
        self.save_fails = 0      # armed, not yet consumed
        self.restore_fails = 0
        self.fired: collections.Counter = collections.Counter()

    @property
    def scheduled(self) -> int:
        return len(self.plan.specs)

    def poll(self, now_s: float) -> List[FaultSpec]:
        """Activate specs due by ``now_s``; returns the ones the
        scheduler itself must apply (everything but copy failures)."""
        out = []
        specs = self.plan.specs
        while self._idx < len(specs) and specs[self._idx].at_s <= now_s:
            spec = specs[self._idx]
            self._idx += 1
            if spec.kind == "save_fail":
                self.save_fails += spec.count
            elif spec.kind == "restore_fail":
                self.restore_fails += spec.count
            else:
                out.append(spec)
        return out

    def take_copy_fail(self, which: str) -> bool:
        """Consume one armed copy failure ('save' | 'restore')."""
        if which == "save" and self.save_fails > 0:
            self.save_fails -= 1
            self.fired["save_fail"] += 1
            return True
        if which == "restore" and self.restore_fails > 0:
            self.restore_fails -= 1
            self.fired["restore_fail"] += 1
            return True
        return False

    def mark(self, kind: str) -> None:
        """Record a scheduler-applied fault as landed."""
        assert kind in KINDS, kind
        self.fired[kind] += 1

    def counters(self) -> Dict[str, int]:
        """Stable-keyed fired counts (zero-kinds omitted)."""
        return {k: self.fired[k] for k in KINDS if self.fired[k]}
