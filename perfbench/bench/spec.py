"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``limits/<cell>.json`` under this folder, and each per-layer metric is
read by ``metrics/<metric>.py``.  A later change adds files and entries;
nothing here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = HERE.parent                                  # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> Dict[str, Any]:
    return load_json(path)


def config(name: str) -> Dict[str, Any]:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict[str, Any]:
    return load_json(HERE / "limits" / f"{cell}.json")


_READERS: Dict[str, ModuleType] = {}


def reader(metric: str) -> ModuleType:
    """The module ``metrics/<metric>.py`` (its ``read(run)`` gives the
    metric's value or ``None``)."""
    mod = _READERS.get(metric)
    if mod is None:
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[metric] = mod
    return mod


@dataclass
class Cell:
    """One ``workloads`` entry with its files loaded."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str, e2e: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, listing
    none, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e


def cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``bench`` (default ``BENCHMARK.json``): its
    configuration, traffic and limits, and the metrics it reports."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=config(entry["config"]),
                traffic=traffic(entry["traffic"]), limits=limits(name),
                end_to_end=e2e, per_layer=layer)
