"""Batch-1 / batched streaming decode engine — the paper's workload.

Port of ``repro.serving.engine`` (the ``generate_continuous`` scheduler
arrives with its own slice).  Generation runs one of two loops:

  step-streamed — one host call of ``Model.decode_step`` per token (what a
                  Python serving loop does; pays the launch tax once per
                  token)
  fused-loop    — ``Model.decode_steps`` over all N tokens with sampling
                  on the device, the tokens read back once at the end

Everything runs under ``torch.inference_mode()``; tokens stay on the
device between steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model
from repro_torch.quant import quantize_tree
from repro_torch.serving.sampling import sample


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # (B, n_new)
    step_times_s: List[float]     # per-token wall times (step-streamed, timed)
    tokens_per_s: float


class DecodeEngine:
    def __init__(self, model: Model, params, *, quant_path: str = "bf16"):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.device = model.device
        with torch.inference_mode():
            self.params = (quantize_tree(params, quant_path)
                           if quant_path != "bf16" else params)
        self.quant_path = quant_path

    # -------------------------------------------------------------- API
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def new_cache(self, batch: int, max_len: int):
        return self.model.init_cache(batch, max_len)

    @torch.inference_mode()
    def prefill(self, batch: Dict, max_len: int):
        B = next(iter(batch.values())).shape[0]
        cache = self.new_cache(B, max_len)
        return self.model.prefill(self.params, batch, cache)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def generate_streamed(self, batch: Dict, *, max_len: int, n_new: int,
                          temperature: float = 0.0, top_k: int = 0,
                          seed: int = 0, timed: bool = False) -> GenerationResult:
        """One host call per token (the paper's streaming workload).

        The generation wall is always timed (``tokens_per_s`` is real
        whether or not per-step instrumentation is on); ``timed=True``
        additionally synchronises after every step to record per-step
        walls for percentile reporting."""
        logits, cache = self.prefill(batch, max_len)
        gen = self._generator(seed)
        out, times = [], []
        tok = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        out.append(tok)
        self._sync()
        t_gen = time.perf_counter()
        for _ in range(n_new - 1):
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(self.params, cache, tok[:, None])
            tok = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
            if timed:
                self._sync()
                times.append(time.perf_counter() - t0)
            out.append(tok)
        self._sync()
        wall = time.perf_counter() - t_gen
        tokens = torch.stack(out, dim=1)
        tps = (n_new - 1) / wall if n_new > 1 and wall > 0 else float("nan")
        return GenerationResult(tokens, times, tps)

    @torch.inference_mode()
    def generate_fused(self, batch: Dict, *, max_len: int, n_new: int,
                       seed: int = 0, temperature: float = 0.0,
                       top_k: int = 0) -> GenerationResult:
        """N tokens through ``Model.decode_steps``: sampling on the device
        and one read-back of the token matrix at the end."""
        logits, cache = self.prefill(batch, max_len)
        gen = self._generator(seed)
        tok0 = sample(logits[:, -1], gen, temperature=temperature, top_k=top_k)
        self._sync()
        t0 = time.perf_counter()
        toks, _ = self.model.decode_steps(self.params, cache, tok0[:, None], gen,
                                          horizon=n_new - 1,
                                          temperature=temperature, top_k=top_k)
        self._sync()
        dt = time.perf_counter() - t0
        tokens = torch.cat([tok0[:, None], toks], dim=1)
        tps = (n_new - 1) / dt if n_new > 1 and dt > 0 else float("nan")
        return GenerationResult(tokens, [], tps)

    def generate_continuous(self, *args, **kwargs):
        raise NotImplementedError("continuous batching arrives with the "
                                  "paged / continuous-batching slice")
