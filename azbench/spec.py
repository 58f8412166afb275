"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, read from
``azbench/traffic/<traffic>.json``. A per-layer metric is read by
``azbench/metrics/<name>.py``, whose ``read(record)`` returns the value, or
None where the record holds nothing to read. Later cells and metrics come
as new files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict  # the configuration's file, as run
    traffic: Dict  # the traffic mix's file
    end_to_end: List[Dict]  # BENCHMARK.json's entries
    per_layer: List[Dict]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError if it has none."""
    with open(BENCHMARK) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, int(work["chips"]), config, traffic, bench["end_to_end"],
                bench["per_layer"])


def reader(metric: str) -> Callable:
    """``read`` of ``azbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"azbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
