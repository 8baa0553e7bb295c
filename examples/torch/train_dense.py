"""Train a small dense LM on the PyTorch port for a few hundred steps on
the learnable synthetic stream, with a mid-run simulated preemption and
a restart from the latest checkpoint -- the fault-tolerance path end to
end, on the card unless ``--device cpu``.

    python examples/torch/train_dense.py [--steps 200] [--device cpu]

``train_dense(cfg, params, device, steps, ckpt_dir)`` is the example's
work from given initial weights (the tests feed it weights bridged from
the JAX package); ``main`` draws them from a seeded ``torch.Generator``.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model, resolve_device  # noqa: E402
from repro_torch.training import (AdamW, DataLoader, Preemption,  # noqa: E402
                                  cosine_schedule, jit_train_step, make_train_step,
                                  run_training, trainable)


def config():
    return get_config("olmo-1b").reduced().replace(
        d_model=192, d_ff=384, n_layers=4, vocab_size=512)


def train_dense(cfg, params, device, steps: int, ckpt_dir: str):
    """``steps`` steps of the arith stream (batch 16, seq 64, seed 3) from
    ``params`` (left untouched), AdamW on a cosine schedule (peak 3e-3,
    20 warm-up steps), remat of every block, a checkpoint every 25 steps
    and one preemption at ``steps // 2``.  Returns ``run_training``'s
    result."""
    model = Model(cfg, device=device)
    opt = AdamW(lr=cosine_schedule(3e-3, 20, steps))
    step = jit_train_step(make_train_step(model, opt, remat="blocks"))

    def init_state():
        p = trainable(_clone(params))
        return (p, opt.init(p))

    loader = DataLoader(cfg, batch=16, seq_len=64, seed=3, mode="arith", device=device)
    armed = {"on": True}

    def preempt_once(s):
        if s == steps // 2 and armed["on"]:
            armed["on"] = False
            print(f"  !! simulated preemption at step {s} -- restarting "
                  f"from latest checkpoint")
            raise Preemption(s)

    return run_training(train_step=step, init_state=init_state, loader=loader,
                        ckpt_dir=ckpt_dir, total_steps=steps, ckpt_every=25,
                        failure_hook=preempt_once)


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone(v) for v in node]
    return node.detach().clone() if isinstance(node, torch.Tensor) else node


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config()
    params = Model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))
    with tempfile.TemporaryDirectory() as ckpt:
        res = train_dense(cfg, params, device, args.steps, ckpt)
    losses = [h["loss"] for h in res.metrics_history]
    print(f"steps={res.step} restarts={res.restarts}")
    print(f"loss: start {losses[0]:.3f} -> end {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise SystemExit("the loss should fall on the arith stream")
    print("OK")


if __name__ == "__main__":
    main()
