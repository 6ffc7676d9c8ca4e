"""Where a cell's parts live, found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: a configuration's sizes;
- ``benchmark/traffic/<traffic>.json``: a traffic mix's parameters, whose
  ``runner`` names the module of ``benchmark/harness`` that runs it;
- ``benchmark/limits/<workload>.json``: the limit of each number that
  decides the cell's ``correct``;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx, outcome)`` that returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)                                         # the checkout


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = benchmark(root)
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    here = os.path.join(root, "benchmark")
    limits_path = os.path.join(here, "limits", f"{name}.json")
    limits = _json(limits_path) if os.path.isfile(limits_path) else {}

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in reported and mine(m)]
    return Cell(w, _json(os.path.join(root, conf["file"])),
                _json(os.path.join(here, "traffic", f"{w['traffic']}.json")), limits, e2e, layer)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(mix: dict):
    """The module that runs a traffic mix: ``benchmark.harness.<runner>``."""
    return importlib.import_module(f"benchmark.harness.{mix['runner']}")
