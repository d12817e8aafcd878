"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``lmibench/configs/<config>.json``;
* a traffic mix: ``lmibench/traffic/<traffic>.json`` (read by
  ``lmibench.generator``);
* the limits of a cell's comparison: ``lmibench/limits/<workload>.json``;
* a metric, end-to-end or per-layer: ``lmibench/metrics/<name>.py``, a
  module with ``read(record) -> float | None``.

A later cell, mix, configuration or metric is a new file and a new
entry; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return _json(path)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_named('config', name)}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{_named('traffic', name)}.json")


def limits(workload: str) -> Dict[str, float]:
    return _json(HERE / "limits" / f"{_named('workload', workload)}.json")


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{_named('metric', name)}.py"


def metric_module(name: str) -> ModuleType:
    path = metric_path(name)
    mod_spec = importlib.util.spec_from_file_location(f"lmibench.metrics.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def end_to_end(bench: dict, workload: str) -> List[dict]:
    """The end-to-end metrics the cell reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics the cell reports (``--trace 1``): those that
    list it, or, without a list, those whose ``moves`` it reports."""
    moved = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
