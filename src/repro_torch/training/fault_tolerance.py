"""The fault-tolerant training loop: checkpoint / restart and preemption
handling.

Port of ``repro.training.fault_tolerance``.  ``run_training`` is the
loop shape

  restore-or-init -> step loop -> periodic atomic checkpoint
      -> on preemption: restore the latest checkpoint + replay the cursor

``failure_hook`` lets tests kill the loop at a chosen step and assert
bit-identical recovery: the data pipeline is a pure function of its
cursor and the optimizer state is checkpointed, so a restarted run
reproduces the uninterrupted loss curve exactly.  A restored state
takes the layout of ``init_state()``'s: a DTensor state (``launch/train.py
--distributed``) comes back on the current mesh, whatever layout saved
it (the reference's ``state_shardings``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataLoader
from repro_torch.training.tree import tree_leaves

log = logging.getLogger("repro_torch.fault_tolerance")


class Preemption(RuntimeError):
    """Simulated SIGTERM from the cluster scheduler."""


@dataclasses.dataclass
class TrainRunResult:
    step: int
    metrics_history: List[Dict[str, float]]
    restarts: int


def _synchronize(state: Any) -> None:
    """Wait for the card's work on ``state`` (``jax.block_until_ready``)."""
    devices = {t.device for t in tree_leaves(state) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def run_training(*, train_step: Callable, init_state: Callable[[], Any],
                 loader: DataLoader, ckpt_dir: str, total_steps: int,
                 ckpt_every: int = 50, keep: int = 3,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 max_restarts: int = 3) -> TrainRunResult:
    """The fault-tolerant loop.  ``train_step(state, batch)`` is the step
    (``jit_train_step``'s, or the plain one); ``init_state()`` builds a
    fresh (params, opt_state)."""
    restarts = 0
    history: List[Dict[str, float]] = []

    while True:
        try:
            # ---- restore or init ----
            state = init_state()
            start = 0
            if ckpt.latest_step(ckpt_dir) is not None:
                state, manifest = ckpt.restore(ckpt_dir, state)
                start = manifest["step"]
                log.info("restored checkpoint at step %d", start)
            loader.cursor.step = start

            # ---- step loop ----
            for step in range(start, total_steps):
                if failure_hook is not None:
                    failure_hook(step)     # may raise Preemption
                batch = next(loader)
                state, metrics = train_step(state, batch)
                history.append({k: float(v) for k, v in metrics.items()})
                if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                    _synchronize(state)
                    ckpt.save(ckpt_dir, step + 1, state,
                              cursor={"step": step + 1}, keep=keep)
            return TrainRunResult(total_steps, history, restarts)

        except Preemption as e:
            restarts += 1
            log.warning("preempted at %s (restart %d/%d)", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
            # fall through: loop restarts from latest checkpoint
