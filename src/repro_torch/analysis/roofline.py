"""Three-term roofline from dry-run artifacts (assignment §Roofline).

  compute_t    = FLOPs / (chips x peak_FLOP/s)
  memory_t     = HBM bytes / (chips x HBM bw)
  collective_t = collective wire bytes per chip / ICI link bw

Sources per cell JSON (written by launch/dryrun.py):
  * cost_analysis flops/bytes (XLA; undercounts while bodies — recorded
    as *_xla), * the analytic model (analysis/analytic.py; exact in
    layer count — used for the headline terms), * parsed collective
    bytes (analysis/hlo.py, while-corrected).

Emits the per-cell table for EXPERIMENTS.md §Roofline including the
dominant term, MODEL_FLOPS/HLO_FLOPs usefulness ratio, and a one-line
"what would move the dominant term" hint.

A copy of ``repro.analysis.roofline`` on the port's ``core/hardware.py``
copy, held equal to the original by ``tests/test_torch_analysis.py``.
The cells come from the port's ``launch/dryrun.py`` (its collective
bytes from ``analysis/collectives.py``).  ``GPU_H100.ici_bw`` is None in
the hardware table, so ``build_row(cell, GPU_H100)`` raises TypeError:
pass ``analysis.links.h100_chip()``, which adds the NVLink term.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.core.hardware import DEFAULT_CHIP, ChipSpec


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    compute_t: float
    memory_t: float
    collective_t: float
    model_flops: float
    total_flops: float
    dominant: str
    useful_ratio: float
    hint: str

    @property
    def step_t(self) -> float:
        return max(self.compute_t, self.memory_t, self.collective_t)

    @property
    def roofline_fraction(self) -> float:
        """max-term / sum-of-terms: 1.0 = perfectly overlapped single
        bottleneck; low = badly balanced."""
        s = self.compute_t + self.memory_t + self.collective_t
        return self.step_t / s if s else 0.0


_HINTS = {
    "compute": ("more chips on the batch axes, or cut recompute "
                "(remat policy) / MoE capacity factor"),
    "memory": ("quantise streamed weights (int8/int4 fused), shard "
               "weights wider, or quantise the KV cache"),
    "collective": ("reshard to cut per-block all-reduces (2D sharding, "
                   "all-gather-weights vs all-reduce-activations), "
                   "overlap collectives with compute"),
}


def build_row(cell: Dict, chip: ChipSpec = DEFAULT_CHIP) -> RooflineRow:
    n = cell["n_chips"]
    flops = cell["analytic"]["flops"]
    hbm = cell["analytic"]["hbm_bytes_per_chip"]
    coll = cell["collectives"]["total_wire_bytes_per_chip"]
    compute_t = flops / (n * chip.peak_flops_bf16)
    memory_t = hbm / chip.hbm_bw
    collective_t = coll / chip.ici_bw
    terms = {"compute": compute_t, "memory": memory_t, "collective": collective_t}
    dominant = max(terms, key=terms.get)
    mf = cell["analytic"]["model_flops"]
    return RooflineRow(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
        n_chips=n, compute_t=compute_t, memory_t=memory_t,
        collective_t=collective_t, model_flops=mf, total_flops=flops,
        dominant=dominant,
        useful_ratio=mf / flops if flops else 0.0,
        hint=_HINTS[dominant])


def load_cells(result_dir: str) -> List[Dict]:
    cells = []
    for p in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def markdown_table(rows: List[RooflineRow]) -> str:
    hdr = ("| arch | shape | chips | compute (ms) | memory (ms) | "
           "collective (ms) | bound | useful | step floor (ms) |\n"
           "|---|---|---:|---:|---:|---:|---|---:|---:|\n")
    body = ""
    for r in rows:
        body += (f"| {r.arch} | {r.shape} | {r.n_chips} | "
                 f"{r.compute_t*1e3:.3f} | {r.memory_t*1e3:.3f} | "
                 f"{r.collective_t*1e3:.3f} | **{r.dominant}** | "
                 f"{r.useful_ratio:.2f} | {r.step_t*1e3:.3f} |\n")
    return hdr + body


def main(result_dir: str = "results/dryrun", mesh: Optional[str] = "pod"):
    cells = [c for c in load_cells(result_dir)
             if c.get("status") == "ok" and (mesh is None or c["mesh"] == mesh)]
    rows = [build_row(c) for c in cells]
    print(markdown_table(rows))
    for r in rows:
        print(f"{r.arch}/{r.shape}: {r.dominant}-bound -> {r.hint}")


if __name__ == "__main__":
    import sys
    main(*sys.argv[1:])
