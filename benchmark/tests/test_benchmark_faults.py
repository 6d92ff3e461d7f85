"""The check catches a broken timed path: the harness's run on the CPU
(the look for a card skipped), with the program broken underneath, reads
``correct`` false, once for each fault the cells can have (an answer
altered where it is produced; half of a batch left out). A step that
returns its state unchanged and an exchange between chips do not exist
in these cells: they train nothing and run on one card."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.run import run_cell

from .helpers import SEED, fixture_cell


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _correct(cell_name: str) -> bool:
    return run_cell(fixture_cell(cell_name), SEED, 0.1, False,
                    device="cpu")["result"]["correct"]


def test_sound_runs_are_correct():
    assert _correct("tiny.realign")
    assert _correct("tiny.catalog")


def test_kernel_answer_altered(monkeypatch):
    from paragraph_tpu_torch.ops import multi_sw

    real = multi_sw.PairedGraphSW.finalize_pairs

    def altered(self, handle):
        results = real(self, handle)
        f_out, r_out = results[0]
        score = np.array(f_out[0])
        score[0] += 1
        results[0] = ((score,) + tuple(f_out[1:]), r_out)
        return results

    monkeypatch.setattr(multi_sw.PairedGraphSW, "finalize_pairs", altered)
    assert not _correct("tiny.realign")


def test_kernel_half_batch_left_out(monkeypatch):
    from paragraph_tpu_torch.ops import multi_sw

    real = multi_sw.PairedGraphSW.score_pairs_device

    def half(self, reads_per_pair):
        return real(self, [r[:len(r) // 2] for r in reads_per_pair])

    monkeypatch.setattr(multi_sw.PairedGraphSW, "score_pairs_device", half)
    assert not _correct("tiny.realign")


def test_genotype_altered(monkeypatch):
    from paragraph_tpu_torch.pipeline import grmpy

    real = grmpy.count_and_genotype

    def altered(*args, **kwargs):
        rec = real(*args, **kwargs)
        for sample in rec["samples"].values():
            gt = sample.get("gt", {})
            if "GQ" in gt:
                gt["GQ"] = gt["GQ"] + 1
        return rec

    monkeypatch.setattr(grmpy, "count_and_genotype", altered)
    assert not _correct("tiny.catalog")


def test_half_the_reads_left_out(monkeypatch):
    from paragraph_tpu_torch.pipeline import grmpy

    real = grmpy.extract_reads

    def half(*args, **kwargs):
        reads = real(*args, **kwargs)
        return reads[:len(reads) // 2]

    monkeypatch.setattr(grmpy, "extract_reads", half)
    assert not _correct("tiny.catalog")
