"""The readings a cell's correctness limit is set from (not run by the
benchmark's runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds <s> [--out <file.json>]

In one process, for each seed: weights and traffic from the seed, the
driver's warm-up, a window of ``--seconds`` at the cell's own load, and
the widest logit gap of the run's sample against the float32 reference
(the lower reading).  For each control seed, on the same sample: the
widest gap of the tokens that the float8 reference puts first (the
upper reading).  Prints one JSON line per seed, and writes them all to
``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main(argv=None) -> int:
    import torch
    import pb_check
    import pb_manifest
    import pb_model
    from pb_drive import DRIVERS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = pb_manifest.load_cell(pb_manifest.load(), args.workload)
    cfg, spec = cell.config, cell.traffic
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    model = pb_model.port_model(cfg, device)
    weights = None
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        weights = pb_model.make_weights(cfg, seed, device, out=weights)
        driver = DRIVERS[spec["driver"]](
            model, pb_model.port_params(cfg, weights), spec, seed)
        with torch.inference_mode():
            driver.warm()
            rec = driver.window(args.seconds)
            driver.finish(rec)
        traffic = driver.traffic
        driver.close()
        del driver
        picked = pb_check.sample(rec, seed, int(spec["sample_tokens"]))
        t0 = time.perf_counter()
        gaps = pb_check.gaps(cfg, weights, traffic, picked)
        row = {"workload": cell.name, "seed": seed,
               "requests": len(picked),
               "tokens": sum(len(r.tokens) for r in picked),
               "gap": max(gaps), "gaps": gaps,
               "reference_s": time.perf_counter() - t0}
        if seed in controls:
            control = pb_check.gaps(cfg, weights, traffic, picked, control=True)
            row.update(control_gap=max(control), control_gaps=control)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
