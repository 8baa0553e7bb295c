"""Whether the timed path's output is right: ``correct``.

Once the window has closed and the program's state is freed, a sample of
the window's finished requests, drawn from the seed and holding the
longest of them, runs through the plain float32 reference
(``pb_reference``): its prompt and the tokens the port served, all but
the last.  At each served token's position the reference's best logit is
compared with the served token's; the widest gap over the sample is the
number held to the cell's limit.  The port's tokens are greedy, so every
served token should be the reference's best, up to the rounding of the
bfloat16 the configuration states.

Three counts are held too: tokens served short of or past a finished
request's budget (limit 0), requests that ended in a failure (limit 0),
and tokens compared (at least 1: a window that finished nothing cannot
be judged right).

The limits live in ``perfbench/limits/<cell>.json``, with the readings
they were set from.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

import pb_metrics
from pb_drive import Record, Req
from pb_reference import Reference, worst_gap
from pb_traffic import Traffic


def sample(rec: Record, seed: int, want_tokens: int) -> List[Req]:
    done = [r for r in pb_metrics.window_requests(rec) if r.status == "ok"]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.index))
    rest = [r for r in done if r is not longest]
    picked, total = [longest], len(longest.tokens)
    for k in np.random.default_rng([seed % 2 ** 64, 5]).permutation(len(rest)):
        if total >= want_tokens:
            break
        picked.append(rest[k])
        total += len(rest[k].tokens)
    return picked


def _sequences(traffic: Traffic, picked: Sequence[Req], device):
    seqs, served = [], []
    for r in picked:
        toks = np.concatenate([traffic.prompt(r.index),
                               np.asarray(r.tokens[:-1], np.int32)])
        seqs.append((torch.from_numpy(toks).long().to(device), r.prompt_len - 1))
        served.append(torch.tensor(r.tokens, device=device))
    return seqs, served


def gaps(cfg: Mapping, weights, traffic: Traffic, picked: Sequence[Req],
         control: bool = False) -> List[float]:
    """Each picked request's widest gap: of the served tokens, or with
    ``control``, of the tokens the float8 reference puts first."""
    seqs, served = _sequences(traffic, picked, weights["embed"].device)
    ref = Reference(cfg).logits(weights, seqs)
    if control:
        low = Reference(cfg, "float8").logits(weights, seqs)
        served = [lg.argmax(dim=-1) for lg in low]
    return [worst_gap(lg, tok) for lg, tok in zip(ref, served)]


def judge(cfg: Mapping, weights, traffic: Traffic, rec: Record, seed: int,
          limits: Mapping) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}})."""
    picked = sample(rec, seed, int(traffic.spec["sample_tokens"]))
    gap = max(gaps(cfg, weights, traffic, picked)) if picked else float("inf")
    done = [r for r in pb_metrics.window_requests(rec) if r.status == "ok"]
    numbers = {
        "gap": {"value": gap, "limit": float(limits["gap"]["limit"])},
        "budget_miss": {"value": sum(abs(len(r.tokens) - r.budget) for r in done),
                        "limit": 0},
        "failed": {"value": sum(r.status not in ("ok", "open")
                                for r in pb_metrics.window_requests(rec)),
                   "limit": 0},
    }
    compared = sum(len(r.tokens) for r in picked)
    correct = (compared >= 1
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    numbers["compared"] = {"value": compared, "limit": 1}
    return correct, numbers
