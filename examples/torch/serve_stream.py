"""End-to-end serving on the PyTorch port (the paper's workload): a small
model served through the ``DecodeEngine`` -- batched streams, batch-1
per-token latency under three weight paths, and the fused generation
loop against the streamed one -- on the card unless ``--device cpu``.

    python examples/torch/serve_stream.py [--device cpu]

``serve_stream(cfg, params, device, tokens)`` is the example's work on
given weights and prompts (the tests feed it weights bridged from the
JAX package); ``main`` draws both from seeded ``torch.Generator``s.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.models.model import Model, resolve_device  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402

QUANT_PATHS = ("bf16", "int8_fused", "int4_fused")


def config():
    return get_config("qwen2.5-3b").reduced().replace(
        d_model=256, d_ff=512, n_layers=8, vocab_size=2048)


def serve_stream(cfg, params, device, tokens: torch.Tensor) -> dict:
    """``tokens`` (8, prompt) int64: 8 streams of 32 tokens, then the first
    prompt alone, 24 tokens under each of QUANT_PATHS (p50 step ms), then
    32 tokens by the streamed and the fused loop (bf16)."""
    model = Model(cfg, device=device)
    engine = DecodeEngine(model, params)
    t0 = time.perf_counter()
    res = engine.generate_streamed({"tokens": tokens}, max_len=128, n_new=32, timed=True)
    wall = time.perf_counter() - t0
    out = {"streams": res.tokens.cpu(), "wall_s": wall,
           "step_p50_ms": stats.p50(res.step_times_s) * 1e3, "p50_ms": {}}
    one = {"tokens": tokens[:1]}
    for quant in QUANT_PATHS:
        eng = engine if quant == "bf16" else DecodeEngine(model, params, quant_path=quant)
        r = eng.generate_streamed(one, max_len=128, n_new=24, timed=True)
        out["p50_ms"][quant] = stats.p50(r.step_times_s) * 1e3
    r_stream = engine.generate_streamed(one, max_len=128, n_new=32)
    r_fused = engine.generate_fused(one, max_len=128, n_new=32)
    out["streamed"], out["fused"] = r_stream.tokens.cpu(), r_fused.tokens.cpu()
    out["fused_tokens_per_s"] = r_fused.tokens_per_s
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config()
    params = Model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (8, 24),
                           generator=torch.Generator().manual_seed(1)).to(device)
    out = serve_stream(cfg, params, device, tokens)

    print("== batched sessions (8 concurrent streams) ==")
    print(f"  8 streams x 32 tokens in {out['wall_s']:.2f}s "
          f"({8 * 32 / out['wall_s']:.0f} tok/s aggregate, {device.type})")
    print(f"  per-step p50 {out['step_p50_ms']:.2f} ms")
    print("== batch-1 streaming (per-token latency) ==")
    for quant, p50 in out["p50_ms"].items():
        print(f"  {quant:11s} p50 step {p50:.2f} ms")
    print("== whole-generation fused loop (one CUDA graph on the card) ==")
    equal = bool(torch.equal(out["fused"], out["streamed"]))
    print(f"  fused: {out['fused_tokens_per_s']:.0f} tok/s; greedy tokens equal: {equal}")
    if not equal:
        raise SystemExit("the fused loop's tokens differ from the streamed loop's")
    print("OK")


if __name__ == "__main__":
    main()
