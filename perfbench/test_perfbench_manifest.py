"""BENCHMARK.json and the files it names: the contract's names, units,
limits and cross references (CPU only)."""
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import pb_manifest  # noqa: E402

M = pb_manifest.load(ROOT)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WIDTHS = re.compile(r"(_dim|_rank|_size|_factor|experts_per_tok)$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(M, indent=2)) < 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert M["paths"] == ["perfbench"]
    assert len(M["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in M["command"])
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.fullmatch(entry["name"])
    for text in (entry[k] for k in ("why", "layer") if k in entry):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("perfbench/configs/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.fullmatch(key) and not WIDTHS.search(key), key
    assert any(w["config"] == cfg["name"] for w in M["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cells(cell):
    w, = [w for w in M["workloads"] if w["name"] == cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
    c = pb_manifest.load_cell(M, cell)
    assert c.limits["gap"]["limit"] > 0
    got = pb_manifest.reports(M, cell)
    names = {m["name"] for m in got["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and got["per_layer"]
    pairs = [(x["config"], x["traffic"]) for x in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_at_most_a_quarter_of_cells_on_four_chips():
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    e2e = metric in M["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert callable(pb_manifest.reader(metric["name"]))
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        moved, = [m for m in M["end_to_end"] if m["name"] == metric["moves"]]
        # every cell that reads the metric reports the end-to-end metric it moves
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", CELLS)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"] \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_named_alike():
    """Metrics of one layer give it letter for letter."""
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
    by_word = {}
    for x in layers:
        by_word.setdefault(x.split()[0], set()).add(x)
    assert all(len(v) == 1 or k == "model" for k, v in by_word.items()), by_word


def test_kernel_rooflines_have_a_step_mfu_beside_them():
    for m in M["per_layer"]:
        if "roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in M["per_layer"])
