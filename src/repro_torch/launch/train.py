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
``/tmp/repro_ckpt``, which a second run resumes from).  Single device:
``--distributed`` raises.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
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

    if args.distributed:
        raise NotImplementedError(
            "--distributed: the multi-device launch (sharding, mesh, hints) "
            "is not ported yet (ROADMAP Queue 1 item 3)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.steps // 10 + 1, args.steps))
    step = make_train_step(model, opt, remat=args.remat,
                           microbatches=args.microbatches)
    step_fn = jit_train_step(step)

    def init_state():
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = trainable(model.init(gen))
        return (params, opt.init(params))

    loader = DataLoader(cfg, batch=args.batch, seq_len=args.seq_len,
                        seed=args.seed, mode=args.data_mode, device=model.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        result = run_training(train_step=step_fn, init_state=init_state,
                              loader=loader, ckpt_dir=ckpt_dir,
                              total_steps=args.steps,
                              ckpt_every=args.ckpt_every)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not result.metrics_history:
        print(f"steps={result.step}: the checkpoint in {ckpt_dir} is at the "
              f"last step already (restarts={result.restarts})")
        return
    first = result.metrics_history[0]["loss"]
    last = result.metrics_history[-1]["loss"]
    print(f"steps={result.step} loss {first:.4f} -> {last:.4f} "
          f"(restarts={result.restarts})")


if __name__ == "__main__":
    main()
