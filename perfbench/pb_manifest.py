"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` runs the configuration
``perfbench/configs/<config>.json`` under the traffic file
``perfbench/traffic/<traffic>.json``, holds its output to
``perfbench/limits/<cell>.json``, and reports each metric through
``perfbench/metrics/<metric>.py``: a function ``read(run)``.  A metric
split by the kind of cell (``tpot_ms.serve``) reads through its own file
where it has one, and otherwise through the file of its name without the
last part (``tpot_ms.py``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Mapping

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Mapping
    traffic: Mapping
    limits: Mapping
    end_to_end: List[Mapping]
    per_layer: List[Mapping]


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(manifest: Mapping, cell: str) -> Dict[str, List[Mapping]]:
    """The metrics a cell reports, by kind: an end-to-end metric where its
    ``workloads`` name the cell or it has none; a per-layer metric where
    its ``workloads`` name the cell or, without them, where the cell
    reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def load_cell(manifest: Mapping, name: str, here: Path = HERE) -> Cell:
    w, = [w for w in manifest["workloads"] if w["name"] == name]
    c, = [c for c in manifest["configs"] if c["name"] == w["config"]]
    got = reports(manifest, name)
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(ROOT / c["file"]),
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_json(here / "limits" / f"{name}.json"),
                end_to_end=got["end_to_end"], per_layer=got["per_layer"])


def reader_path(metric: str, here: Path = HERE) -> Path:
    """``perfbench/metrics/<metric>.py``, or, where there is none, the file
    of the name without its last dotted part."""
    path = here / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return reader_path(metric.rsplit(".", 1)[0], here)
    return path


def reader(metric: str, here: Path = HERE) -> Callable:
    """``read`` of the metric's file (names hold dots, so the file is
    loaded by its path)."""
    path = reader_path(metric, here)
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
