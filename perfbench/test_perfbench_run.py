"""Whole runs of the benchmark's cells cut to a CPU test's size: the result
line, the port against the plain reference, and ``correct`` coming out
false when the timed path is broken underneath (CPU only: the harness's
look for a card is skipped, the rest of a run is driven as on the card)."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import pb_tiny  # noqa: E402
from pb_tiny import B1, SERVE  # noqa: E402

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", [B1, SERVE])
def test_result_line(name, trace):
    cell = pb_tiny.cell(name)
    out, numbers = pb_tiny.run(cell, trace=trace)
    assert KEYS <= set(out) <= KEYS | {"breakdown"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in wanted}
    for m in wanted:
        if m["name"] in out["metrics"]:
            got = out["metrics"][m["name"]]
            assert got["unit"] == m["unit"] and got["value"] == got["value"]
            if m["unit"] == "%":
                assert 0 <= got["value"] <= 100
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert ("busy_s" in out["device"]) == trace == ("breakdown" in out)
    assert set(numbers) == {"gap", "budget_miss", "failed", "compared"}
    assert all({"value", "limit"} == set(v) for v in numbers.values())
    json.dumps(out)


@pytest.mark.parametrize("name", [B1, SERVE])
def test_port_matches_the_reference_in_float32(name):
    """In float32 the port's served tokens are the reference's best, to
    float32 rounding: the comparison itself is sound."""
    out, numbers = pb_tiny.run(pb_tiny.cell(name, dtype="float32"))
    assert out["correct"] and numbers["compared"]["value"] >= 48
    assert numbers["gap"]["value"] < 1e-3


OPTIONS = {
    "b1-poisson": (B1, {"arrivals": {"kind": "poisson", "rate_rps": 4.0}}),
    "serve-poisson": (SERVE, {"arrivals": {"kind": "poisson", "rate_rps": 40.0}}),
    "serve-bursty": (SERVE, {"arrivals": {"kind": "bursty", "rate_rps": 40.0,
                                          "burst_len": 4, "burst_factor": 4.0}}),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_open_loop_arrivals(option):
    """Open-loop arrivals, which a later cell can take by a data file
    alone, run through both drivers, the check and the metrics; each
    phase's schedule starts when the phase does, so a slow warm-up leaves
    the window's requests on time."""
    name, change = OPTIONS[option]
    cell = pb_tiny.cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **change))
    out, numbers = pb_tiny.run(cell)
    assert out["correct"] is True and out["failed"] == 0, numbers
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
