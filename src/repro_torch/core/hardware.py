"""Hardware tier registry.

The paper ladders four NVIDIA GPUs by peak HBM bandwidth; we ladder TPU
generations the same way and keep the paper's GPU specs so the floor
arithmetic can be validated against the paper's own Table 9 numbers.

All bandwidths are *decimal* bytes/s, matching the paper's convention
(it quotes W in decimal GB).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    kind: str                  # "tpu" | "gpu"
    peak_flops_bf16: float     # FLOP/s
    hbm_bw: float              # bytes/s (decimal)
    hbm_bytes: float           # capacity, bytes
    ici_bw: Optional[float]    # bytes/s per ICI link (TPU); None for GPU
    usd_per_hour: float        # list price used for the cost ladder

    def t_floor_s(self, bytes_streamed: float) -> float:
        return bytes_streamed / self.hbm_bw


# --- TPU ladder (the deployment ladder under test on our side) ----------
# v5e constants are pinned by the assignment: 197 TFLOP/s bf16, 819 GB/s
# HBM, ~50 GB/s/link ICI.
TPU_V5E = ChipSpec("tpu-v5e", "tpu", 197e12, 819e9, 16e9, 50e9, 1.20)
TPU_V4 = ChipSpec("tpu-v4", "tpu", 275e12, 1228e9, 32e9, 50e9, 3.22)
TPU_V6E = ChipSpec("tpu-v6e", "tpu", 918e12, 1640e9, 32e9, 90e9, 2.70)
TPU_V5P = ChipSpec("tpu-v5p", "tpu", 459e12, 2765e9, 95e9, 90e9, 4.20)

# --- the paper's GPUs (validation of the floor model only) --------------
# B_peak from paper §3.3; prices: paper quotes Modal $3.50/hr H100 and
# $0.30/hr L4 (May 2026); A100/L40S filled from Modal list prices.
GPU_H100 = ChipSpec("h100-sxm5", "gpu", 989e12, 3350e9, 80e9, None, 3.50)
GPU_A100 = ChipSpec("a100-80gb", "gpu", 312e12, 2039e9, 80e9, None, 2.50)
GPU_L40S = ChipSpec("l40s", "gpu", 362e12, 864e9, 48e9, None, 1.95)
GPU_L4 = ChipSpec("l4", "gpu", 121e12, 300e9, 24e9, None, 0.30)

CHIPS: Dict[str, ChipSpec] = {
    c.name: c
    for c in [TPU_V5E, TPU_V4, TPU_V6E, TPU_V5P, GPU_H100, GPU_A100, GPU_L40S, GPU_L4]
}

TPU_LADDER = [TPU_V5E, TPU_V4, TPU_V6E, TPU_V5P]          # ordered by HBM bw
GPU_LADDER = [GPU_L4, GPU_L40S, GPU_A100, GPU_H100]       # the paper's ladder

# Primary roofline target (assignment-pinned).
DEFAULT_CHIP = TPU_V5E


def get_chip(name: str) -> ChipSpec:
    return CHIPS[name]
