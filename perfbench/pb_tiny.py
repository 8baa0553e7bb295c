"""Cells cut to a CPU test's size: the benchmark's own cells, with a tiny
configuration and traffic of the same shape.  The drivers, the check and
the metrics run as on the card; only the window closes after a number of
finished requests instead of after its seconds, so that a test's outcome
does not hang on how busy the machine running it is."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from unittest import mock

import torch

import pb_drive
import pb_manifest
import pb_run

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=512)
B1 = "qwen2.5-7b.b1-ctx2048"
SERVE = "qwen2.5-7b.serve-16"


def cell(name: str, dtype: str = "bfloat16", **config) -> pb_manifest.Cell:
    c = pb_manifest.load_cell(pb_manifest.load(), name)
    tiny = dict(c.config, **TINY, torch_dtype=dtype)
    tiny.update(config)
    traffic = dict(c.traffic)
    if traffic["driver"] == "engine_stream":
        traffic.update(prompt_len={"fixed": 24}, new_tokens={"fixed": 24},
                       max_len=48, sample_tokens=48)
    else:
        traffic.update(prompt_len={"log_uniform": [16, 40]},
                       new_tokens={"uniform": [12, 24]}, pool=16, max_len=64,
                       arrivals={"kind": "closed", "clients": 4},
                       scheduler=dict(traffic["scheduler"], n_slots=4,
                                      page_size=8, prefill_chunk=16),
                       ramp_ticks=3, trace_ticks=2, sample_tokens=48)
    return dataclasses.replace(c, config=tiny, traffic=traffic)


def _window(finished: int):
    def window(self, seconds):
        t0 = time.perf_counter()
        first = len(self.requests)
        self._base = None
        self._run_until(lambda: sum(r.status == "ok" for r in
                                    self.requests[first:]) >= finished)
        return self.record(t0, time.perf_counter())
    return window


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as the runs on the card use: the tests share
    their machine with others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run(c: pb_manifest.Cell, seed: int = 2 ** 31 + 11, trace: bool = False,
        finished: int = 4):
    """One run on the CPU whose window closes once ``finished`` requests
    sent in it have finished."""
    with mock.patch.object(pb_drive._Driver, "window", _window(finished)), \
            one_thread():
        return pb_run.run(c, seed, 0.0, trace, torch.device("cpu"),
                          time.perf_counter())
