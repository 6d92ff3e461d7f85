"""A configuration whose program genotypes on the float32 device engine
is judged against the float64 host engine, with float32's GQ rounding
counted apart: the harness on the CPU (the look for a card skipped) runs
the fixture's two-sample cell with ``gt_engine`` "device" (the engine on
the CPU) and reads ``correct`` true; the float16 control, a GL shifted
past the limit, one sample's genotypes altered and a job that raises are
each refused. ``wgs30x-1s`` genotypes in float64 and is judged exactly."""
from __future__ import annotations

import json
import os

import pytest

from benchmark import control, drivers, judge
from benchmark.cells import load_cell
from benchmark.run import run_cell

from .helpers import SEED, fixture_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tiny.population"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run():
    return run_cell(fixture_cell(CELL), SEED, 0.1, False, device="cpu")


def test_float32_program_by_configuration():
    bench = os.path.join(ROOT, "BENCHMARK.json")
    assert not judge.float32_program(
        load_cell("wgs30x.realign", bench).config)
    pop = load_cell("pop30x.catalog150x8", bench).config
    assert judge.float32_program(pop)
    assert pop["options"]["gt_engine"] == "device"
    assert pop["control"]["genotyping"] == "float16"
    assert judge.float32_program(fixture_cell(CELL).config)


def test_device_engine_is_correct_against_the_float64_reference():
    out = _run()
    result, record = out["result"], out["record"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"sv_per_s", "setup_s"}
    checks = result["checks"]
    assert checks["calls_differ"] == {"value": 0, "limit": 0}
    # float32 against float64: GLs apart, far inside the limit
    assert 0.0 < checks["gl_gap"]["value"] < checks["gl_gap"]["limit"] / 10
    last = out["details"][-1]
    assert last["gq_rounded"] >= 0 and last["reference_s"] > 0
    units = record["events"] * record["samples"]
    assert record["samples"] == 2
    for job in record["jobs"]:
        assert job["ok"] and "device_genotype" in job["stage_s"]
        # two breakpoints an event, each genotyped in every sample
        assert job["stats"]["gt_device_jobs"] == 2 * units
    assert last["gt_device_jobs"] == [2 * units] * len(record["jobs"])
    assert out["checked"] == 4 * 2 * len(record["jobs"])


def test_float16_control_is_caught():
    c = fixture_cell(CELL)
    numbers = control.control_numbers(c, SEED, processes=2)
    assert numbers.pop("gq_rounded") >= 0
    ok, _ = judge.verdict(numbers, c.config["limits"])
    assert not ok
    assert numbers["gl_gap"] > c.config["limits"]["gl_gap"]


def test_a_gl_shifted_past_the_limit(monkeypatch):
    from paragraph_tpu_torch.genotyping import device_engine

    real = device_engine._genotype_from_row
    limit = fixture_cell(CELL).config["limits"]["gl_gap"]

    def shifted(out, i, gts):
        g = real(out, i, gts)
        if g.gl:
            g.gl[-1] -= 2 * limit
        return g

    monkeypatch.setattr(device_engine, "_genotype_from_row", shifted)
    out = _run()
    checks = out["result"]["checks"]
    assert out["result"]["correct"] is False
    assert checks["gl_gap"]["value"] > checks["gl_gap"]["limit"]


def test_one_samples_genotypes_altered(monkeypatch):
    from paragraph_tpu_torch.genotyping import graph_genotyper

    cls = graph_genotyper.GraphBreakpointGenotyper
    real = cls.install_genotypes

    def altered(self, by_key):
        last = self.sample_names[-1]
        for (sample, _), g in by_key.items():
            if sample == last and g.gt:
                g.gt = [0, 1] if sorted(g.gt) == [0, 0] else [0, 0]
        return real(self, by_key)

    monkeypatch.setattr(cls, "install_genotypes", altered)
    out = _run()
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["calls_differ"]["value"] > 0


def test_a_job_that_raises_is_refused(monkeypatch):
    from paragraph_tpu_torch.pipeline import multigrmpy

    real = multigrmpy.run
    calls = []

    def second_call_raises(options, *args, **kwargs):
        calls.append(options)
        if len(calls) == 2:  # the warm-up job is the first call
            raise RuntimeError("a job that raises")
        return real(options, *args, **kwargs)

    monkeypatch.setattr(multigrmpy, "run", second_call_raises)
    out = _run()
    result, record = out["result"], out["record"]
    assert not record["jobs"][0]["ok"]
    assert result["failed"] == record["events"] * record["samples"]
    assert result["correct"] is False
    json.loads(json.dumps(result))


def _record(gl, gq=40, gt="0/1", alleles=None):
    gt_rec = {"GT": gt, "GL": gl, "GQ": gq}
    bp = {"counts": {"alleles": alleles or {"REF": 10, "ALT": 10}},
          "gt": dict(gt_rec)}
    return {"s": {"breakpoints": {"bp1": bp}, "gt": dict(gt_rec)}}


#: GQ's error probability e**-34 against 8 float32 ulps of 5.99 (3.8e-6):
#: float32 may give any GQ from int(-10 log10(3.8e-6)) = 54 to 100
UNRESOLVED = {"0/0": -60.0, "0/1": -5.99, "1/1": -40.0}
#: GQ's error probability about e**-5, which float32 resolves
RESOLVED = {"0/0": -30.0, "0/1": -2.0, "1/1": -7.0}


@pytest.mark.parametrize("ref_gl,prog,calls,rounded", [
    # GQ where float32 cannot resolve its error probability: rounded
    (UNRESOLVED, {"gq": 63}, 0, 2),
    (UNRESOLVED, {"gq": 100}, 0, 2),
    # ... but not below the GQ of the probability plus 8 ulps
    (UNRESOLVED, {"gq": 20}, 2, 0),
    # ... and never the GT
    (UNRESOLVED, {"gt": "1/1"}, 2, 0),
    # a GQ that float32 resolves is exact
    (RESOLVED, {"gq": 63}, 2, 0),
    # so is a GT at a tie: the top two GLs 5e-4 apart
    ({"0/0": -30.0, "0/1": -2.0, "1/1": -2.0005}, {"gt": "1/1"}, 2, 0),
    # read counts are never exempted
    (UNRESOLVED, {"alleles": {"REF": 10, "ALT": 11}}, 1, 0),
])
def test_float32_gq_rounding_is_counted_apart(ref_gl, prog, calls, rounded):
    """A GT or GQ change lands on the breakpoint and on the sample's own
    genotype, so it counts twice; read counts are the breakpoint's."""
    ref = _record(ref_gl)
    prog = _record(ref_gl, **prog)
    out = judge.compare_samples(prog, ref, float32=True)
    assert (out["calls_differ"], out["gq_rounded"]) == (calls, rounded)
    assert out["gl_gap"] == 0.0
    # a float64 program: nothing exempted
    assert judge.compare_samples(prog, ref)["calls_differ"] == (
        calls + rounded)
    assert "gq_rounded" not in judge.compare_samples(prog, ref)


def test_gq_floor():
    assert judge.gq_floor({"GL": UNRESOLVED}) == 54
    assert judge.gq_floor({"GL": RESOLVED}) is None
    assert judge.gq_floor({"GL": {"0/0": -3.0}}) is None
