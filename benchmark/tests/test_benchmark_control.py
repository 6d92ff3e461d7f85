"""The controls, at a size a test run holds: the reference at the next
lower precision, in the program's place, fails each cell's comparison.
On the card's host the same runs at the cells' own sizes:
``python3 -m benchmark.control --workload <cell> --seeds a,b,c``."""
from __future__ import annotations

import pytest

from benchmark import control, judge

from .helpers import SEED, fixture_cell


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,number", [
    ("tiny.realign", "k1_outputs_differ"),
    ("tiny.catalog", "gl_gap"),
])
def test_control_is_caught(cell, number):
    c = fixture_cell(cell)
    numbers = control.control_numbers(c, SEED, processes=2)
    ok, rows = judge.verdict(numbers, c.config["limits"])
    assert not ok
    assert numbers[number] > c.config["limits"][number]
