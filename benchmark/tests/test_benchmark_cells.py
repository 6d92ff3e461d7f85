"""Every cell, configuration, mix and metric resolves by name, the
BENCHMARK.json keeps the contract's shape, and a cell made of new files
only (the fixture) resolves and runs its metric readers."""
from __future__ import annotations

import json
import os
import re

from benchmark.cells import load_cell

from .helpers import FIXTURE, fixture_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = load_cell(w["name"], os.path.join(ROOT, "BENCHMARK.json"))
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.traffic["driver"] in ("multigrmpy", "realign")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert set(cell.readers) == names | {m["name"]
                                             for m in cell.per_layer}
        limits = cell.config["limits"]
        assert all(v >= 0 for v in limits.values())


def test_contract_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 0


def test_new_cell_is_new_files():
    cell = fixture_cell("tiny.catalog")
    assert os.path.dirname(cell.readers["tiny_jobs"].__code__.co_filename) \
        == os.path.join(FIXTURE, "metrics")
    run = {"driver": "multigrmpy", "window_s": 2.0, "events": 5,
           "samples": 1, "setup_s": 3.0,
           "jobs": [{"wall_s": 1.0, "stage_s": {}, "ok": True}] * 2}
    assert cell.readers["tiny_jobs"](run) == 2
    # a metric the fixture has no file for is read by the benchmark's own
    assert os.path.dirname(cell.readers["sv_per_s"].__code__.co_filename) \
        == os.path.join(ROOT, "benchmark", "metrics")
    assert cell.readers["sv_per_s"](run) == 5.0
    assert cell.readers["setup_s"](run) == 3.0
