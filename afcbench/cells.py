"""Finding a cell's parts by name: the workload entry of ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<mix>.json``), its
limits (``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).  A new cell, mix or metric is new files and new
entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic mix's contents
    limits: dict            # number compared -> its limit
    end_to_end: List[dict]  # the metrics a --trace 0 run reports
    per_layer: List[dict]   # the metrics a --trace 1 run reports
    package: Path           # where the metric readers live


def load_benchmark(root: Path = REPO) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = REPO,
              package: Optional[Path] = None) -> Cell:
    """The workload ``name`` of ``root``'s ``BENCHMARK.json`` with its
    configuration, traffic mix, limits and every metric; a per-layer
    metric whose reader finds nothing in the cell is left out of its
    line (``read_per_layer``)."""
    root = Path(root)
    package = PACKAGE if package is None else Path(package)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (package / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = package / "limits" / f"{name}.json"
    limits = (json.loads(limits_path.read_text())
              if limits_path.is_file() else {})
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=list(bench["end_to_end"]),
                per_layer=list(bench["per_layer"]),
                package=package)


def metric_reader(cell: Cell, metric: str) -> Callable[[dict], Optional[float]]:
    """``read(record) -> number or None`` of ``metrics/<metric>.py``."""
    path = cell.package / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"afcbench_metric_{metric.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}: "
                                f"{path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, record: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds something
    for, as ``{name: {"value", "unit"}}``; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(cell, m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
