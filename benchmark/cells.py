"""Cells by name: everything of a cell is found from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its
traffic mix; the files are ``benchmark/configs/<config>.json`` and
``benchmark/traffic/<traffic>.json``. Its end-to-end metrics are those of
``end_to_end`` that list it under ``workloads`` or list no cells, its
per-layer metrics likewise; each metric is read by ``read(run)`` of
``benchmark/metrics/<metric name>.py``. A new configuration, mix or
metric is therefore new files and new entries, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(metric: str, base: str = HERE) -> Callable:
    """``read`` of benchmark/metrics/<metric>.py (the name may hold dots)."""
    path = os.path.join(base, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: str = "BENCHMARK.json",
              base: str = HERE) -> Cell:
    """The cell `name` of `bench_json`, with its configuration, traffic
    and metric readers; raises KeyError for an unknown cell."""
    bench = _load_json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_json}")
    w = cells[name]
    config = _load_json(os.path.join(base, "configs", w["config"] + ".json"))
    traffic = _load_json(os.path.join(base, "traffic",
                                      w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {}
    for m in e2e + per_layer:
        own = os.path.join(base, "metrics", m["name"] + ".py")
        readers[m["name"]] = load_reader(
            m["name"], base if os.path.isfile(own) else HERE)
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                readers)
