"""The one traffic generator: requests from a traffic file and a seed.

A traffic file (``perfbench/traffic/<name>.json``) gives:

- ``prompt_len`` and ``new_tokens``: ``{"fixed": n}``, ``{"uniform": [lo,
  hi]}`` or ``{"log_uniform": [lo, hi]}``;
- ``pool``: how many (prompt, new) pairs one cycle holds.  The pairs sit
  at fixed quantiles of the two distributions, paired by a fixed
  permutation, so every seed serves the same set of sizes; the seed only
  orders each cycle;
- ``arrivals``: ``{"kind": "closed", "clients": n}`` (each client sends
  its next request when its last token arrives), ``{"kind": "poisson",
  "rate_rps": r}`` or ``{"kind": "bursty", "rate_rps": r, "burst_len": n,
  "burst_factor": f}`` (open loops: bursts of ``burst_len`` at ``f`` times
  the rate, gaps between them keeping the mean rate, as
  ``repro_torch/serving/trace.py`` draws them);
- the driver's own keys (``perfbench/pb_drive.py``).

Token ids are uniform over the vocabulary, drawn per request from the
seed and the request's index, so any request can be made again.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt_len: int
    new_tokens: int


def _quantiles(spec: Mapping, n: int) -> np.ndarray:
    """n values at the quantiles (k + 1/2) / n of the distribution."""
    (kind, arg), = spec.items()
    u = (np.arange(n) + 0.5) / n
    if kind == "fixed":
        return np.full(n, int(arg))
    lo, hi = arg
    if kind == "uniform":
        return np.rint(lo + u * (hi - lo)).astype(np.int64)
    if kind == "log_uniform":
        return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
                       ).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng([w % 2 ** 64 for w in words])


class Traffic:
    """The request stream of one traffic file under one seed."""

    def __init__(self, spec: Mapping, seed: int, vocab: int):
        self.spec = spec
        self.seed = seed
        self.vocab = vocab
        n = int(spec.get("pool", 1))
        prompts = _quantiles(spec["prompt_len"], n)
        news = _quantiles(spec["new_tokens"], n)[_rng(0).permutation(n)]
        self.pairs = list(zip(prompts.tolist(), news.tolist()))
        self._orders: Dict[int, np.ndarray] = {}
        arrivals = spec["arrivals"]
        self.kind = arrivals["kind"]
        if self.kind not in ("closed", "poisson", "bursty"):
            raise ValueError(f"unknown arrivals {self.kind!r}")
        self.clients = int(arrivals.get("clients", 0))
        self._due: List[float] = []

    def request(self, i: int) -> Request:
        cycle, k = divmod(i, len(self.pairs))
        order = self._orders.get(cycle)
        if order is None:
            order = self._orders[cycle] = _rng(self.seed, 1, cycle).permutation(
                len(self.pairs))
        p, n = self.pairs[order[k]]
        return Request(i, int(p), int(n))

    def prompt(self, i: int) -> np.ndarray:
        """The token ids of request i's prompt (int32)."""
        req = self.request(i)
        return _rng(self.seed, 2, i).integers(0, self.vocab, req.prompt_len,
                                              dtype=np.int32)

    def due(self, i: int) -> Optional[float]:
        """Open loops: request i's send time in seconds after the first
        request's; None for a closed loop.  The gaps are exponential, at
        the quantiles ``(k + 1/2) / pool`` in an order drawn from the seed,
        so every seed offers the same set of gaps."""
        if self.kind == "closed":
            return None
        a = self.spec["arrivals"]
        rate = float(a["rate_rps"])
        n_pool = len(self.pairs)
        while len(self._due) <= i:
            j = len(self._due)
            cycle, k = divmod(j, n_pool)
            u = (_rng(self.seed, 4, cycle).permutation(n_pool)[k] + 0.5) / n_pool
            mean = 1.0 / rate
            if self.kind == "bursty":
                n, f = int(a["burst_len"]), float(a["burst_factor"])
                # inside a burst at f times the rate; the gap before the
                # next burst keeps the long-run mean at the rate
                mean = 1.0 / (rate * f) if j % n else n / rate - (n - 1) / (rate * f)
            gap = -math.log(1.0 - u) * mean if j else 0.0
            self._due.append((self._due[-1] if self._due else 0.0) + gap)
        return self._due[i]
