"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  With ``--trace 0`` the line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics.  The numbers compared with the
reference go to standard error, each beside its limit, as the last lines
there, and under ``check``, the result's last key.  Exit codes: 0 a
result was printed; 2 an unknown cell; 3 too few cards; 4 JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# caches at fixed paths inside the checkout, so only a checkout's first
# run builds; the port builds its kernels into build/kernels there itself
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(HERE), str(ROOT / "src")]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def check_lines(numbers: dict) -> list:
    return [f"check {name} {v['value']!r} "
            f"{'at least' if name == 'compared' else 'limit'} {v['limit']!r}"
            for name, v in numbers.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import pb_manifest
    manifest = pb_manifest.load(ROOT)
    if args.workload not in {w["name"] for w in manifest["workloads"]}:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = pb_manifest.load_cell(manifest, args.workload)

    import torch
    import pb_run
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 3
    out, numbers = pb_run.run(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    out["check"] = numbers
    sys.stderr.write("\n".join(check_lines(numbers)) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
