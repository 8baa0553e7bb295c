"""The traffic generator: seeded streams repeat exactly, and every seed
offers the same sizes (CPU only)."""
import collections
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

from pb_traffic import Traffic  # noqa: E402

SPECS = {p.stem: json.loads(p.read_text()) for p in (HERE / "traffic").glob("*.json")}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_a_seed_repeats_exactly(name):
    seed = 2 ** 31 + 7
    a, b = Traffic(SPECS[name], seed, 1000), Traffic(SPECS[name], seed, 1000)
    for i in (0, 1, 5, 300):
        assert a.request(i) == b.request(i)
        assert np.array_equal(a.prompt(i), b.prompt(i))
        assert a.prompt(i).dtype == np.int32
        assert len(a.prompt(i)) == a.request(i).prompt_len
        assert a.request(i).prompt_len + a.request(i).new_tokens - 1 <= SPECS[name]["max_len"]
    c = Traffic(SPECS[name], seed + 1, 1000)
    assert not np.array_equal(a.prompt(1), c.prompt(1))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_every_seed_serves_the_same_sizes(name):
    spec = SPECS[name]
    n = spec.get("pool", 1)
    sizes = [collections.Counter((r.prompt_len, r.new_tokens)
                                 for r in map(Traffic(spec, s, 100).request, range(n)))
             for s in (1, 2 ** 33 + 5)]
    assert sizes[0] == sizes[1]


def test_serve_sizes_span_their_ranges():
    t = Traffic(SPECS["serve-16"], 3, 100)
    reqs = [t.request(i) for i in range(256)]
    p = [r.prompt_len for r in reqs]
    n = [r.new_tokens for r in reqs]
    assert 256 <= min(p) < 270 and 1990 < max(p) <= 2048
    assert 64 <= min(n) < 66 and 254 < max(n) <= 256
    assert np.median(p) == pytest.approx(724, rel=0.02)      # log-uniform's median


def test_open_loops():
    base = SPECS["serve-16"]
    for arrivals in ({"kind": "poisson", "rate_rps": 4.0},
                     {"kind": "bursty", "rate_rps": 4.0, "burst_len": 4,
                      "burst_factor": 8.0}):
        spec = dict(base, arrivals=arrivals)
        t = Traffic(spec, 9, 500)
        due = [t.due(i) for i in range(512)]
        assert due[0] == 0.0 and all(b >= a for a, b in zip(due, due[1:]))
        assert 512 / due[-1] == pytest.approx(4.0, rel=0.15)
        again = Traffic(spec, 9, 500)
        assert [again.due(i) for i in range(512)] == due
    assert Traffic(SPECS["b1-ctx2048"], 1, 10).due(3) is None
