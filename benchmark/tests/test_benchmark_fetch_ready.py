"""fetch_ready_share.realign: the share of the window's dispatches whose
output was on the host when it was fetched, from the run record's scorer
counters; None where the scorer keeps no fetch_ready counter."""
import pytest

from benchmark.cells import load_reader


def _read(scorer):
    return load_reader("fetch_ready_share.realign")({"scorer": scorer})


def test_share_of_dispatches_found_ready():
    assert _read({"dispatches": 40, "fetch_ready": 37}) == pytest.approx(
        92.5)
    assert _read({"dispatches": 8, "fetch_ready": 0}) == 0.0


def test_none_without_the_counter_or_a_dispatch():
    assert _read({"dispatches": 40, "k1_s": 0.1}) is None
    assert _read({"dispatches": 0, "fetch_ready": 0}) is None
    assert load_reader("fetch_ready_share.realign")({"scorer": None}) is None
