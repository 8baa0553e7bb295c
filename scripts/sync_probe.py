#!/usr/bin/env python3
"""Syncs a call of the port's hot functions under torch's own sync
detector, for this checkout and, with ``--parent``, an older one.

    PYTHONPATH=src python3 scripts/sync_probe.py [--parent <older tree>] [--out FILE]

Each tree runs in a subprocess of its own with its own ``src`` first on
the path (its kernels built into its own ``build/kernels``), through the
drive functions of ``chip_smoke.py``'s phase 22b in this checkout
(qwen2.5-7b at full width, 2 layers, bf16; the paged scheduler at K=1 and K=4;
qwen2.5-3b's captured train step) without the checker: per hot function
the calls, the syncs the card saw a call and each site's chain of the
tree's frames.  The counts are counts, not times, so one run of each
tree is enough.  Writes ``chiprun_out/sync_probe.json`` by default.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(tree: Path) -> dict:
    """Drive the hot functions of ``tree``'s port (this process)."""
    import inspect

    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all()
    cs.ROOT = tree                    # sites as paths of ``tree``
    det = cs.SyncDetector()
    cs.drive_hot_paths(det, torch.device("cuda", 0))
    out = {}
    for name, fn in cs.hot_targets().items():
        calls = det.calls.get(name, 0)
        sites: dict = {}
        for chain in det.sites(inspect.unwrap(fn).__code__):
            text = " > ".join(f"{f}:{line}" for f, line in chain)
            sites[text] = sites.get(text, 0) + 1
        out[name] = dict(calls=calls, syncs_per_call=sum(sites.values()) / max(calls, 1),
                         sites={k: v / max(calls, 1) for k, v in sites.items()})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older checkout to run beside this one")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sync_probe.json"))
    ap.add_argument("--tree", help=argparse.SUPPRESS)     # the child's tree
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(child(Path(args.tree).resolve())))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("sync_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = {"change": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    report = {"card": smi, "trees": {}}
    for label, tree in trees.items():
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                              capture_output=True, text=True, timeout=1500,
                              env=dict(os.environ, PYTHONPATH=""))
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {label} tree's run exited {proc.returncode}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        report["trees"][label] = got
        for name, row in got.items():
            print(f"{label:6s} {name:36s} {row['calls']:4d} calls, "
                  f"{row['syncs_per_call']:.2f} syncs a call {row['sites']}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
