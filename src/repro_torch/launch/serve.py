"""Serving launcher — batch-1 streaming decode, the paper's workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-7b \
      --prompt-len 2048 --new-tokens 32 --timed

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --reduced --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; weights are
random, drawn on the device from ``--seed``.  Continuous batching, paged
KV and tracing arrive with their own slices.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import floor as fl
from repro_torch.core.hardware import GPU_H100
from repro_torch.models.attention import DECODE_BACKENDS
from repro_torch.models.model import Model
from repro_torch.quant import WEIGHT_PATHS
from repro_torch.serving import DecodeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quant", default="bf16", choices=WEIGHT_PATHS)
    ap.add_argument("--weights", default=None,
                    choices=("int8", "int4") + WEIGHT_PATHS,
                    help="weight quantisation path (alias for --quant; bare "
                         "'int8'/'int4' select the fused path)")
    ap.add_argument("--mode", default="streamed", choices=["streamed", "fused"])
    ap.add_argument("--decode-backend", default="cuda", choices=DECODE_BACKENDS,
                    help="decode attention route; 'cuda' is the hand-written "
                         "kernel (its plain version on --device cpu)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--timed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.weights:
        args.quant = {"int8": "int8_fused",
                      "int4": "int4_fused"}.get(args.weights, args.weights)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, decode_backend=args.decode_backend, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    engine = DecodeEngine(model, params, quant_path=args.quant)

    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(prompt).to(model.device)}
    max_len = args.prompt_len + args.new_tokens + 1

    if args.mode == "fused":
        res = engine.generate_fused(batch, max_len=max_len, n_new=args.new_tokens,
                                    temperature=args.temperature, seed=args.seed)
    else:
        res = engine.generate_streamed(batch, max_len=max_len,
                                       n_new=args.new_tokens,
                                       temperature=args.temperature,
                                       seed=args.seed, timed=args.timed)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    print(f"generated {tuple(res.tokens.shape)} tokens on {where}; "
          f"{res.tokens_per_s:.1f} tok/s")
    if args.timed and res.step_times_s:
        p50 = float(np.median(res.step_times_s)) * 1e3
        wb = 0.5 if args.quant.startswith("int4") else 1 if \
            args.quant.startswith("int8") else 2
        fc = fl.floor_cell(cfg, GPU_H100, args.prompt_len, weight_dtype_bytes=wb)
        print(f"p50 step {p50:.3f} ms on {where}; {GPU_H100.name} analytic "
              f"floor {fc.t_floor_ms:.4g} ms, R_floor "
              f"{fc.r_floor(p50 / 1e3):.4g}")
    print("first tokens:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
