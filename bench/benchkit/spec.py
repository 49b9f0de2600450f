"""Finds a cell's data by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration's
file is the one ``BENCHMARK.json`` gives it, and its architecture's
module ``bench/configs/<model_type>.py`` (``configs.arch``); the mix is
``bench/traffic/<traffic>.json``; the limits of the cell's correctness
check are ``bench/limits/<cell>.json``; each per-layer metric is read by
``bench/metrics/<metric>.py``.  A later PR adds a cell by adding such
files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]          # the configuration's file, parsed
    traffic: Dict[str, Any]         # the mix's file, parsed
    limits: Dict[str, float]        # number compared -> its limit
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_config(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """The file of the configuration ``name`` of ``BENCHMARK.json``."""
    bench = _load_json(root / "BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    return _load_json(root / configs[name]["file"])


def load_traffic(name: str) -> Dict[str, Any]:
    return _load_json(BENCH_DIR / "traffic" / f"{name}.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    config = load_config(w["config"], root)
    traffic = load_traffic(w["traffic"])
    limits = _load_json(BENCH_DIR / "limits" / f"{name}.json")
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read(run)`` of ``bench/metrics/<name>.py``: the metric's value
    from a finished run, or None where the run has nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
