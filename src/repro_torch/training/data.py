"""Deterministic synthetic data pipeline with an explicit cursor.

Port of ``repro.training.data``.  Every batch is a pure function of
(seed, step, shard): a restart resumes bit-identically from a
checkpointed cursor, and each data-parallel shard draws a disjoint
stream.  The draws come from numpy's ``default_rng([seed, step,
shard])``, not from JAX's threefry, so the two packages' batches differ
for one cursor (the parity tests feed both the same numpy batch).
Labels are the next tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

MODES = ("uniform", "arith")


@dataclasses.dataclass
class DataCursor:
    seed: int
    step: int

    def to_json(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_json(cls, d):
        return cls(int(d["seed"]), int(d["step"]))


def synthetic_batch(cfg: ArchConfig, cursor: DataCursor, *, batch: int,
                    seq_len: int, shard: int = 0, shard_count: int = 1,
                    mode: str = "uniform", device="cpu") -> Dict[str, torch.Tensor]:
    """Pure function of (seed, step, shard): a (tokens, labels) LM batch
    of this shard's batch // shard_count rows, int64 on ``device``
    ((B, S, K) with audio codebooks).

    mode="uniform": i.i.d. tokens (loss pins at ln V).  mode="arith":
    x_{t+1} = (5 x_t + 17) mod V from a random x_0, learnable structure
    (codebook configs draw uniform tokens in either mode, as the
    reference does).  The vlm batch has ``embeds`` (B, S, D) bf16 and
    ``positions`` (B, S, 3) in place of ``tokens``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if batch % shard_count:
        raise ValueError(f"batch {batch} does not split into {shard_count} shards")
    b_local = batch // shard_count
    rng = np.random.default_rng([cursor.seed, cursor.step, shard])
    V = cfg.vocab_size
    if mode == "arith" and not cfg.n_codebooks:
        seq = [rng.integers(0, V, (b_local,))]
        for _ in range(seq_len):
            seq.append((5 * seq[-1] + 17) % V)
        toks = np.stack(seq, axis=1)
    else:
        shape = ((b_local, seq_len + 1, cfg.n_codebooks) if cfg.n_codebooks
                 else (b_local, seq_len + 1))
        toks = rng.integers(0, V, shape)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        erng = np.random.default_rng([cursor.seed, cursor.step, shard, 1])
        out["embeds"] = erng.standard_normal((b_local, seq_len, cfg.d_model),
                                             dtype=np.float32)
        out["positions"] = np.broadcast_to(np.arange(seq_len)[None, :, None],
                                           (b_local, seq_len, 3))
        out.pop("tokens")
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
    if "embeds" in tensors:
        tensors["embeds"] = tensors["embeds"].to(torch.bfloat16)
    return {k: v.to(device) for k, v in tensors.items()}


class DataLoader:
    """Stateful iterator over the deterministic stream, with a
    checkpointable cursor."""

    def __init__(self, cfg: ArchConfig, *, batch: int, seq_len: int,
                 seed: int = 0, shard: int = 0, shard_count: int = 1,
                 start_step: int = 0, mode: str = "uniform", device="cpu"):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.shard = shard
        self.shard_count = shard_count
        self.mode = mode
        self.device = device
        self.cursor = DataCursor(seed, start_step)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = synthetic_batch(self.cfg, self.cursor, batch=self.batch,
                            seq_len=self.seq_len, shard=self.shard,
                            shard_count=self.shard_count, mode=self.mode,
                            device=self.device)
        self.cursor = DataCursor(self.cursor.seed, self.cursor.step + 1)
        return b
