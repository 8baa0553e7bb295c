"""The paper's §7 experiment on the PyTorch port: the quantisation paths
compared on (a) the analytic weight traffic that each route is charged
and (b) live batch-1 decode, on the card unless ``--device cpu``.

    python examples/torch/quant_ablation.py [--device cpu]

``ablation(cfg, params, device, prompt, ...)`` times the paths of
``WEIGHT_PATHS`` on given weights (the tests feed it weights bridged
from the JAX package; chip_smoke runs it at qwen2.5-7b's full width);
``main`` runs it on a reduced qwen2.5-3b with weights drawn from a
seeded ``torch.Generator``.

The charge is ``tree_weight_traffic`` of the weights each engine runs:
the port's rule, which follows its route.  It stands above the JAX
package's charge for ``int8_fused`` (and for any 3-D int4 stack): those
weights are multiplied by a bf16 copy that the dequantisation kernel
writes and the GEMM reads back, 4 bytes an element more than their codes
and scales, where the reference counts on XLA to fuse the cast into the
GEMM.  Only the 2-D int4 route (kernel 3) reads codes and scales alone.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import floor as fl  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.core.hardware import GPU_H100  # noqa: E402
from repro_torch.models.model import Model, resolve_device  # noqa: E402
from repro_torch.quant import WEIGHT_PATHS, tree_weight_traffic  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402

# bytes a weight element the floor model counts for each path (the
# reference's nominal table)
NOMINAL_BYTES = {"bf16": 2, "int8_dequant": 3, "int8_fused": 1,
                 "int4_dequant": 2.5, "int4_fused": 0.5}


def ablation(cfg, params, device, prompt, *, full=None, paths=WEIGHT_PATHS,
             max_len=64, n_new=16, ctx=2048) -> list:
    """One row per weight path of ``paths``: the charged weight bytes a
    step of the engine that was timed (``tree_weight_traffic`` of its
    quantised params), the p50 step (ms) of ``generate_streamed(prompt,
    max_len, n_new)`` (the engine's graph step on the card), the tokens,
    and the H100 floor of ``full`` (the full config; ``cfg`` itself when
    None) at ``ctx`` with the path's nominal bytes."""
    model = Model(cfg, device=device)
    rows = []
    for path in paths:
        engine = DecodeEngine(model, params, quant_path=path)
        res = engine.generate_streamed(prompt, max_len=max_len, n_new=n_new, timed=True)
        cell = fl.floor_cell(full or cfg, GPU_H100, ctx,
                             weight_dtype_bytes=NOMINAL_BYTES[path])
        rows.append({"path": path, "traffic_bytes": tree_weight_traffic(engine.params),
                     "p50_ms": stats.p50(res.step_times_s) * 1e3,
                     "floor_ms": cell.t_floor_ms, "tokens": res.tokens.cpu()})
        del engine
    return rows


def vs_bf16(rows) -> dict:
    """Each path's charge over bf16's."""
    base = next(r["traffic_bytes"] for r in rows if r["path"] == "bf16")
    return {r["path"]: r["traffic_bytes"] / base for r in rows}


def summary(rows) -> str:
    """What the rows show: which paths the port charges above and below
    bf16, and the order of their p50 steps."""
    ratio = vs_bf16(rows)
    more = [f"{p} {x:.2f}x" for p, x in ratio.items() if x > 1]
    less = [f"{p} {x:.2f}x" for p, x in ratio.items() if x < 1]
    order = " < ".join(r["path"] for r in sorted(rows, key=lambda r: r["p50_ms"]))
    return (f"charged above bf16: {', '.join(more) or 'none'} (each multiplies by a "
            f"bf16 copy written once and read once); below: {', '.join(less) or 'none'}"
            f"; p50 step, fastest first: {order}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen2.5-3b").reduced().replace(vocab_size=1024)
    params = Model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 16),
                                      generator=torch.Generator().manual_seed(1)).to(device)}
    rows = ablation(cfg, params, device, prompt, full=get_config("qwen2.5-3b"))
    print(f"{'path':14s} {'traffic':>9s} {'vs bf16':>8s} {device.type + ' p50':>9s} "
          f"{'H100 floor (full arch)':>23s}")
    ratio = vs_bf16(rows)
    for r in rows:
        print(f"{r['path']:14s} {r['traffic_bytes']/1e6:7.2f}MB {ratio[r['path']]:7.2f}x "
              f"{r['p50_ms']:7.2f}ms {r['floor_ms']:19.2f}ms")
    print(f"\n{summary(rows)}")
    print("OK")


if __name__ == "__main__":
    main()
