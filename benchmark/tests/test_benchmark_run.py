"""The harness end to end on the CPU (the plain fill; the command itself
refuses the CPU): the result line's keys and the refusal without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

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
