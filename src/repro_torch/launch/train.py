"""Training launcher.

Port of ``repro.launch.train``: builds the model, runs the
fault-tolerant loop (training/fault_tolerance.py) with atomic
checkpoints, and prints ``steps=N loss a -> b (restarts=R)``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --reduced --device cpu --steps 20

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --batch 1 --seq-len 2048 --remat blocks --steps 10

Runs on the CUDA card unless ``--device cpu`` is given (raises without
CUDA); weights are random, drawn on the device from ``--seed``.  On the
card the step is one captured CUDA graph (``jit_train_step``).
Checkpoints go to ``--ckpt-dir``; without it, to a new temporary
directory that is removed at the end (the reference defaults to a fixed
``/tmp/repro_ckpt``, which a second run resumes from).

``--distributed``: one process per device, e.g.

  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen2.5-3b --distributed

The launcher joins the process group already started in the process, or
starts one (NCCL on ``cuda``, gloo on ``cpu``) from the environment
``torch.distributed.run`` sets; each rank takes the device of its local
rank.  As the reference does, it lays a (data=W, model=1) mesh over the
W ranks, plans the state with ``launch/sharding.py`` (params, moments
and the step counter as DTensors) and runs the step under
``activation_hints(mesh)``.  Every rank loads the world-1 batch and
splits its rows over ``data``, so the loss line equals the run without
the flag.  The step runs uncaptured (``make_train_step``'s plain
function): a CUDA graph holding the collectives is not built.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.hints import activation_hints
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Model
from repro_torch.training import (AdamW, DataLoader, cosine_schedule,
                                  jit_train_step, make_train_step,
                                  run_training, trainable)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "blocks", "full"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory, removed at the end")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-mode", default="arith", choices=["uniform", "arith"])
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    mesh = plan = None
    if args.distributed:
        device = _join_group(device)
        mesh = make_test_mesh(data=dist.get_world_size(), model=1,
                              device_type=device.type)
        plan = shd.make_plan(cfg, mesh)
    model = Model(cfg, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.steps // 10 + 1, args.steps))
    step = make_train_step(model, opt, remat=args.remat,
                           microbatches=args.microbatches)
    if plan is None:
        step_fn = jit_train_step(step)
    else:
        print(f"distributed: {dist.get_world_size()} rank(s) on a (data="
              f"{dist.get_world_size()}, model=1) mesh; the step runs "
              "uncaptured on DTensors")

        def step_fn(state, batch):
            return step(state, shd.distribute(batch, shd.batch_shardings(plan, batch)))

    def init_state():
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = trainable(model.init(gen))
        state = (params, opt.init(params))
        if plan is not None:
            state = shd.distribute(state, state_shardings(plan, state))
        return state

    loader = DataLoader(cfg, batch=args.batch, seq_len=args.seq_len,
                        seed=args.seed, mode=args.data_mode, device=model.device)
    ckpt_dir = args.ckpt_dir or _temp_dir(plan is not None)
    hints = activation_hints(mesh) if mesh is not None else contextlib.nullcontext()
    try:
        with hints:
            result = run_training(train_step=step_fn, init_state=init_state,
                                  loader=loader, ckpt_dir=ckpt_dir,
                                  total_steps=args.steps,
                                  ckpt_every=args.ckpt_every)
    finally:
        if args.ckpt_dir is None and (plan is None or dist.get_rank() == 0):
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not result.metrics_history:
        print(f"steps={result.step}: the checkpoint in {ckpt_dir} is at the "
              f"last step already (restarts={result.restarts})")
        return
    first = result.metrics_history[0]["loss"]
    last = result.metrics_history[-1]["loss"]
    print(f"steps={result.step} loss {first:.4f} -> {last:.4f} "
          f"(restarts={result.restarts})")


def state_shardings(plan, state):
    """The layouts of a train state (params, AdamW state) under ``plan``."""
    params, opt_state = state
    return (shd.params_shardings(plan, params),
            shd.opt_state_shardings(plan, opt_state))


def _join_group(device: torch.device) -> torch.device:
    """Join the process group the process has started, or start one
    (NCCL on cuda, gloo on cpu) from ``torch.distributed.run``'s
    environment; returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              if not dist.is_initialized()
                              else torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                **({"device_id": device} if device.type == "cuda"
                                   else {}))
    return device


def _temp_dir(shared: bool) -> str:
    """A new temporary checkpoint directory; under ``--distributed``
    rank 0 makes it and every rank takes its name."""
    if not shared:
        return tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    name = [tempfile.mkdtemp(prefix="repro_torch_ckpt_") if dist.get_rank() == 0
            else None]
    dist.broadcast_object_list(name, src=0)
    return name[0]


if __name__ == "__main__":
    main()
