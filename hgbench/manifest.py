"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

  * a configuration: the ``file`` its ``configs`` entry names;
  * a traffic mix: ``hgbench/traffic/<traffic>.json``;
  * a cell's correctness limits: ``hgbench/limits/<workload>.json``;
  * a per-layer metric: its reader ``hgbench/metrics/<metric>.py``, a
    module with ``read(ctx)`` (``readers.py``).

A new cell, mix, configuration or metric is new files and new entries:
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Optional[dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def workloads(root: Path = ROOT) -> List[str]:
    return [w["name"] for w in load(root)["workloads"]]


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load(root)
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = matches[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    limits_path = root / "hgbench" / "limits" / f"{name}.json"
    return Cell(name=name, chips=w["chips"], config_name=conf["name"],
                config=_json(root / conf["file"]), traffic_name=w["traffic"],
                traffic=_json(root / "hgbench" / "traffic" / f"{w['traffic']}.json"),
                limits=_json(limits_path) if limits_path.exists() else None,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The module ``hgbench/metrics/<metric>.py``, loaded by its path (a
    metric's name may hold dots)."""
    path = Path(root) / "hgbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"hgbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], root) for m in cell.per_layer}
