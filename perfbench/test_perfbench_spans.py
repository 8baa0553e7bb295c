"""Spanned phases (``pb_spans.py``) on the CPU: a phase of each cell
kind through its driver at a tiny size, where spans have no device
interval; a port without the recorder; and the arithmetic of the device
readings on spans made up here."""
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import pb_drive  # noqa: E402
import pb_model  # noqa: E402
import pb_spans  # noqa: E402
import pb_tiny  # noqa: E402
from pb_drive import DRIVERS, Record  # noqa: E402
from pb_tiny import B1, SERVE  # noqa: E402

CPU = torch.device("cpu")
NAMES = {B1: {"engine.request", "engine.prefill", "engine.first_token",
              "engine.replay", "engine.sample", "engine.readback"},
         SERVE: {"sched.tick", "sched.admit", "sched.chunk", "sched.dispatch",
                 "sched.readback", "sched.reconcile"}}
HOST = {B1: set(), SERVE: {"chunk_host_ms", "reconcile_ms"}}


def _driver(name, seed=2 ** 31 + 5):
    """The cell's driver at a tiny size, warmed up, as ``pb_run`` makes it."""
    cell = pb_tiny.cell(name)
    cfg, spec = cell.config, cell.traffic
    model = pb_model.port_model(cfg, CPU)
    weights = pb_model.make_weights(cfg, seed, CPU)
    driver = DRIVERS[spec["driver"]](model, pb_model.port_params(cfg, weights),
                                     spec, seed)
    driver.warm()
    return driver


def _phase(name):
    with mock.patch.object(pb_drive._Driver, "window", pb_tiny._window(4)), \
            pb_tiny.one_thread(), torch.inference_mode():
        return pb_spans.phase(_driver(name), 0.0, CPU)


@pytest.mark.parametrize("name", [B1, SERVE])
def test_spanned_phase_of_each_cell_kind(name):
    sp = _phase(name)
    got = {s["name"] for s in sp.export["spans"]}
    assert NAMES[name] <= got and not sp.has_device()
    assert all(sp.record.t0 * 1e9 <= s["t0_ns"] for s in sp.export["spans"])
    line = pb_spans.line(sp)
    for span in NAMES[name]:
        assert f"{span} " in line
    assert "graph_captures 0, kernel_builds 0, dropped 0" in line
    read = pb_spans.readings(sp)
    assert {k for k, v in read.items() if v is not None} == HOST[name]
    assert all(read[k] > 0 for k in HOST[name])


@pytest.mark.parametrize("name", [B1, SERVE])
def test_a_port_without_the_recorder_runs_no_spanned_phase(name, monkeypatch):
    """An older tree of the port: no ``core/spans.py``."""
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert _phase(name) is None
    assert all(v is None for v in pb_spans.readings(None).values())


def _span(sid, name, t0, t1, dev=None, parent=-1, request=None, counts=None):
    return {"id": sid, "name": name, "parent": parent, "request": request,
            "t0_ns": t0, "t1_ns": t1, "device": dev, "counts": counts or {}}


def _spanned(spans, t0=0, t1=None):
    t1 = max(s["t1_ns"] for s in spans) if t1 is None else t1
    record = Record(t0 * 1e-9, t1 * 1e-9, [], [], [], [])
    return pb_spans.Spanned(record, {"spans": spans, "dropped": 0,
                                     "counters": {"graph_captures": 0,
                                                  "kernel_builds": 0}})


US = 1000


def _b1():
    """Two requests; between its two tokens the device idles 100 us in the
    first, 40 us in the second."""
    out = [_span(0, "engine.request", 5 * US, 2000 * US, request=1),
           _span(1, "engine.prefill", 10 * US, 500 * US, [10 * US, 600 * US], 0, 1),
           _span(2, "engine.replay", 700 * US, 720 * US, [700 * US, 900 * US], 0, 1),
           _span(3, "engine.sample", 720 * US, 730 * US, [900 * US, 950 * US], 0, 1),
           _span(4, "engine.readback", 730 * US, 960 * US, None, 0, 1),
           _span(5, "engine.replay", 1050 * US, 1060 * US, [1050 * US, 1250 * US], 0, 1),
           _span(6, "engine.sample", 1060 * US, 1070 * US, [1250 * US, 1300 * US], 0, 1),
           _span(7, "engine.request", 2000 * US, 3000 * US, request=2),
           _span(8, "engine.replay", 2100 * US, 2110 * US, [2100 * US, 2300 * US], 7, 2),
           _span(9, "engine.sample", 2110 * US, 2120 * US, [2300 * US, 2350 * US], 7, 2),
           _span(10, "engine.replay", 2390 * US, 2400 * US, [2390 * US, 2590 * US], 7, 2),
           _span(11, "engine.sample", 2400 * US, 2410 * US, [2590 * US, 2640 * US], 7, 2)]
    return _spanned(out, t1=3000 * US)


def test_decode_idle_and_replay_device_time():
    sp = _b1()
    idle, span = pb_spans.decode_idle(sp)
    assert (idle, span) == (140 * US, (1300 - 700 + 2640 - 2100) * US)
    read = pb_spans.readings(sp)
    assert read["decode_idle"] == pytest.approx(100.0 * 140 / 1140)
    assert read["replay_device_ms"] == pytest.approx(0.2)
    assert read["tick_idle"] is None and read["chunk_host_ms"] is None


def test_idle_goes_to_the_innermost_span_at_each_gaps_middle(monkeypatch):
    monkeypatch.setattr(pb_spans, "MIN_GAP_NS", 20 * US)
    idle, n_short, short_s = pb_spans.idle_by_span(_b1())
    # 0-10 us before the prefill's device work: too short to place;
    # 600-700, 950-1050 and 1300-2100 (its middle inside the first
    # request), 2350-2390 and 2640-3000: each request's own time between
    # its children
    assert n_short == 1 and short_s == pytest.approx(10e-6)
    assert idle == pytest.approx(
        {"engine.request": (100 + 100 + 800 + 40 + 360) * 1e-6})


def test_short_gaps_are_not_placed(monkeypatch):
    monkeypatch.setattr(pb_spans, "MIN_GAP_NS", 50 * US)
    idle, n_short, short_s = pb_spans.idle_by_span(_b1())
    assert n_short == 2 and short_s == pytest.approx(50e-6)
    assert idle == pytest.approx(
        {"engine.request": (100 + 100 + 800 + 360) * 1e-6})


def test_tick_idle_counts_the_ticks_outside_every_program():
    ticks = [_span(0, "sched.tick", 0, 1000 * US),
             _span(1, "sched.admit", 0, 400 * US, parent=0),
             _span(2, "sched.chunk", 100 * US, 300 * US, [100 * US, 500 * US], 1, "0",
                   {"tokens": 512}),
             _span(3, "sched.dispatch", 400 * US, 450 * US, [450 * US, 800 * US], 0),
             _span(4, "sched.readback", 450 * US, 800 * US, parent=0),
             _span(5, "sched.reconcile", 800 * US, 900 * US, parent=0),
             # a tick whose chunk's device work outlasts it
             _span(6, "sched.tick", 1100 * US, 1200 * US),
             _span(7, "sched.chunk", 1110 * US, 1150 * US, [1150 * US, 1500 * US], 6, "1")]
    sp = _spanned(ticks)
    idle, total = pb_spans.tick_idle(sp)
    # tick 1: busy 100-800 of 0-1000; tick 2: busy 1150-1200 of 1100-1200
    assert (idle, total) == (300 * US + 50 * US, 1100 * US)
    read = pb_spans.readings(sp)
    assert read["tick_idle"] == pytest.approx(100.0 * 350 / 1100)
    assert read["chunk_host_ms"] == pytest.approx(0.12)
    assert read["reconcile_ms"] == pytest.approx(0.1)
    assert read["replay_device_ms"] is None and read["decode_idle"] is None
    line = pb_spans.line(sp)
    assert line.startswith("sched.admit 1 host 0.400 ms dev - idle ")
    assert "sched.chunk 2 host 0.240 ms dev 0.750 ms" in line
