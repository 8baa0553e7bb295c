"""Quickstart on the PyTorch port: build any assigned architecture, run
a train step and a few greedy decode steps on a reduced config -- on the
card unless ``--device cpu`` is passed.

    python examples/torch/quickstart.py [--arch qwen2-moe-a2.7b] [--device cpu]

``quickstart(cfg, params, device, batch, prompt)`` is the example's work
on given weights and data (the tests feed it weights bridged from the
JAX package); ``main`` draws the weights from a seeded
``torch.Generator`` and the data from the port's ``DataLoader``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.core import floor as fl  # noqa: E402
from repro_torch.core.hardware import GPU_H100  # noqa: E402
from repro_torch.models.model import Model, resolve_device  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402
from repro_torch.training import (AdamW, DataLoader, jit_train_step,  # noqa: E402
                                  make_train_step, trainable)


def quickstart(cfg, params, device, batch, prompt) -> dict:
    """One train step (AdamW, lr 1e-3; one captured CUDA graph on the
    card) on ``batch``, then 8 greedy tokens from ``prompt`` with the
    updated params (none for the vlm, which takes embeddings).  Returns
    the step's loss and grad norm, the tokens (or None) and tok/s."""
    model = Model(cfg, device=device)
    opt = AdamW(lr=1e-3)
    step = jit_train_step(make_train_step(model, opt))
    params = trainable(params)
    state, metrics = step((params, opt.init(params)), batch)
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "tokens": None, "tokens_per_s": None}
    if cfg.family != "vlm":
        engine = DecodeEngine(model, state[0])
        res = engine.generate_streamed(prompt, max_len=96, n_new=8, timed=True)
        out["tokens"], out["tokens_per_s"] = res.tokens.cpu(), res.tokens_per_s
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b", choices=list_configs())
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    full = get_config(args.arch)
    cfg = full.reduced()
    print(f"arch={full.name} family={full.family} "
          f"params={fl.param_count(full)/1e9:.2f}B "
          f"active={fl.active_param_count(full)/1e9:.2f}B")
    cell = fl.floor_cell(full, GPU_H100, 2048)
    print(f"H100 batch-1 decode floor @ctx=2048: {cell.t_floor_ms:.2f} ms "
          f"(the paper's t_floor=(W+K)/B_peak at {GPU_H100.hbm_bw / 1e12:.2f} TB/s)")

    params = Model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))
    loader = DataLoader(cfg, batch=4, seq_len=32, mode="arith", device=device)
    batch = next(loader)
    prompt = next(loader)
    prompt.pop("labels")
    out = quickstart(cfg, params, device, batch, prompt)
    print(f"train step: loss={out['loss']:.3f} grad_norm={out['grad_norm']:.2f}")
    if out["tokens"] is not None:
        print(f"decode: generated {out['tokens'].shape[1]} tokens/seq, "
              f"{out['tokens_per_s']:.1f} tok/s (reduced model, {device.type})")
        print("tokens:", out["tokens"][0].tolist())
    print("OK")


if __name__ == "__main__":
    main()
