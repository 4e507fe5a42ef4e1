"""A cell of BENCHMARK.json, resolved to its files by name.

A configuration is the file its entry names and a traffic mix is
`benchmark/traffic/<name>.json`, both beside the benchmark file (the
checkout's root); the code a mix's entry names is `entries/<name>.py`, a
per-layer metric's reader `metrics/<name>.py`, a kernel's launch counter
`counters/<kernel>.py` and its work count `roofline/<kernel>.py`. A metric
applies to a cell when it lists the cell under `workloads`, or lists none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    name: str
    config: dict
    config_dir: Path
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def by_name(folder: Path, name: str):
    """The module `folder/<name>.py`, loaded by its path (a name may hold
    dots)."""
    path = Path(folder) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{path.parent.name}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, bench_path: Path) -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    base = Path(bench_path).resolve().parent
    config_path = base / configs[cell["config"]]["file"]
    traffic_path = base / "benchmark" / "traffic" / f"{cell['traffic']}.json"
    return Cell(
        name=workload,
        config=json.loads(config_path.read_text()),
        config_dir=config_path.parent,
        traffic=json.loads(traffic_path.read_text()),
        chips=cell["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])
