"""The harness end to end on the CPU (the plain fill; the command itself
refuses the CPU): the result line's keys and the refusal without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import stages
from benchmark.run import run_cell

from .helpers import SEED, fixture_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_result_line_is_well_formed():
    out = run_cell(fixture_cell("tiny.realign"), SEED, 0.1, False,
                   device="cpu")
    result = out["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["checks"] == {"k1_outputs_differ": {"value": 0,
                                                      "limit": 0}}
    json.loads(json.dumps(result))


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "wgs30x.realign", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("name", ["tiny.catalog", "tiny.pipelined"])
def test_multigrmpy_cells_read_sv_per_s(name):
    out = run_cell(fixture_cell(name), SEED, 0.1, False, device="cpu")
    result = out["result"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"sv_per_s", "setup_s"}
    assert result["metrics"]["sv_per_s"]["value"] > 0
    assert set(result["checks"]) == {"calls_differ", "gl_gap"}


def test_pipelined_stages_add_up_to_the_wall_time():
    """The stages are disjoint: no completed job's time outside every
    stage is below 0, on the detail line and job by job. Then the three
    host readers and the detail line's other stages make up the jobs'
    wall time; the device's idle share needs a traced run on a card."""
    host = ("entry_ms_per_sv.catalog1k", "graph_build_ms_per_sv.catalog1k",
            "extract_wait_ms_per_sv.catalog1k")
    out = run_cell(fixture_cell("tiny.pipelined"), SEED, 0.1, True,
                   device="cpu")
    metrics, record = out["result"]["metrics"], out["record"]
    assert set(metrics) == set(host)
    assert all(metrics[m]["value"] > 0 for m in host)
    split = out["details"][-1]["ms_per_event_by_stage"]
    rest = sum(split.get(k, 0.0) for k in ("score_dispatch",
                                           "device_wait+submit",
                                           "device_genotype"))
    jobs = [j for j in record["jobs"] if j["ok"]]
    assert jobs and out["details"][-1]["completed_jobs"] == len(jobs)
    assert out["details"][-1]["outside_min_s"] >= 0
    assert all(stages.seconds(j)[stages.OUTSIDE] >= 0 for j in jobs)
    wall = 1000.0 * sum(j["wall_s"] for j in jobs) / (record["events"]
                                                      * len(jobs))
    assert sum(metrics[m]["value"] for m in host) + rest == pytest.approx(
        wall)
