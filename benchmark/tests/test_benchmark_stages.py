"""The multigrmpy cell's readers (``sv_per_s`` and the four per-layer
metrics of ``wgs30x.catalog1k``) on a made-up run record worked by hand,
and on a realign record, where each reads nothing.

The record: 10 events, 1 sample, a window of 20 s and three jobs, the
last of which raised. Job 1, wall 8 s: load 0.5, graph_build 1,
extract_wait 2, score_dispatch 0.5, device_wait+submit 1, analysis_wait
1.5, write_json 0.25, vcf_update 0.25, so 1 s outside every stage. Job
2, wall 10 s: load 1, graph_build 2, extract_wait 3, score_dispatch 0.5,
device_wait+submit 0.5, analysis_wait 0.5, write_json 0.5, vcf_update
0.5, so 1.5 s outside. Over the two completed jobs (20 events):
- sv_per_s: 10 x 1 x 2 / 20 = 1.0;
- entry: (0.5 + 0.25 + 0.25 + 1) + (1 + 0.5 + 0.5 + 1.5) = 5.5 s, 275 ms
  an event;
- graph_build: 3 s, 150 ms an event;
- extract_wait + analysis_wait: (2 + 1.5) + (3 + 0.5) = 7 s, 350 ms;
- device idle: 1 - 5 / 20 = 75%;
- the rest (score_dispatch, device_wait+submit): 2.5 s, 125 ms; the four
  parts add up to the 18 s of wall time, 900 ms an event.
"""
import pytest

from benchmark import stages
from benchmark.cells import load_reader

READERS = ("sv_per_s", "entry_ms_per_sv.catalog1k",
           "graph_build_ms_per_sv.catalog1k",
           "extract_wait_ms_per_sv.catalog1k", "device_idle_share.catalog1k")


def multigrmpy_run():
    job1 = {"load": 0.5, "graph_build": 1.0, "extract_wait": 2.0,
            "score_dispatch": 0.5, "device_wait+submit": 1.0,
            "analysis_wait": 1.5, "write_json": 0.25, "vcf_update": 0.25}
    job2 = {"load": 1.0, "graph_build": 2.0, "extract_wait": 3.0,
            "score_dispatch": 0.5, "device_wait+submit": 0.5,
            "analysis_wait": 0.5, "write_json": 0.5, "vcf_update": 0.5}
    return {"driver": "multigrmpy", "window_s": 20.0, "events": 10,
            "samples": 1, "trace": {"busy_s": 5.0},
            "jobs": [{"wall_s": 8.0, "stage_s": job1, "stats": {},
                      "ok": True},
                     {"wall_s": 10.0, "stage_s": job2, "stats": {},
                      "ok": True},
                     {"wall_s": 2.0, "stage_s": {"load": 0.5}, "stats": {},
                      "ok": False}]}


@pytest.mark.parametrize("metric,value", [
    ("sv_per_s", 1.0),
    ("entry_ms_per_sv.catalog1k", 275.0),
    ("graph_build_ms_per_sv.catalog1k", 150.0),
    ("extract_wait_ms_per_sv.catalog1k", 350.0),
    ("device_idle_share.catalog1k", 75.0),
])
def test_readers_on_a_worked_record(metric, value):
    assert load_reader(metric)(multigrmpy_run()) == pytest.approx(value)


@pytest.mark.parametrize("metric,value", [
    # 1.5 s of device_genotype over 20 events and 2 samples
    ("device_genotype_ms_per_sv.catalog150x8", 37.5),
    # score_dispatch + device_wait+submit: 2.5 s
    ("scorer_ms_per_sv.catalog150x8", 62.5),
    # extract_wait + analysis_wait: 7 s
    ("extract_wait_ms_per_sv.catalog150x8", 175.0),
    ("device_idle_share.catalog150x8", 75.0),
])
def test_population_readers_per_event_and_sample(metric, value):
    """The worked record with 2 samples a job and the device engine's
    stage (0.5 s in job 1, 1 s in job 2): milliseconds per event x
    sample."""
    run = multigrmpy_run()
    run["samples"] = 2
    run["jobs"][0]["stage_s"]["device_genotype"] = 0.5
    run["jobs"][1]["stage_s"]["device_genotype"] = 1.0
    assert load_reader(metric)(run) == pytest.approx(value)
    assert load_reader(metric)({"driver": "realign", "window_s": 20.0,
                                "trace": {"busy_s": 5.0}}) is None
    if metric.startswith("device_genotype"):
        assert load_reader(metric)(multigrmpy_run()) is None  # host engine


def test_the_split_adds_up_to_the_wall_time():
    run = multigrmpy_run()
    split = stages.split(run["jobs"], run["events"])
    assert split[stages.OUTSIDE] == pytest.approx(125.0)
    assert sum(split.values()) == pytest.approx(900.0)
    rest = sum(v for k, v in split.items()
               if k not in stages.ENTRY + stages.GRAPHS + stages.WORKERS)
    assert rest == pytest.approx(125.0)
    host = sum(load_reader(m)(run) for m in READERS[1:4])
    assert host + rest == pytest.approx(900.0)
    # disjoint stages leave each job a time outside them of 0 or more;
    # stages counted twice would not
    assert [stages.seconds(j)[stages.OUTSIDE] for j in run["jobs"][:2]] == [
        pytest.approx(1.0), pytest.approx(1.5)]
    run["jobs"][0]["stage_s"]["graph_build"] += 2.0
    assert stages.seconds(run["jobs"][0])[stages.OUTSIDE] < 0


def test_a_failed_job_lowers_sv_per_s():
    run = multigrmpy_run()
    for job in run["jobs"]:
        job["ok"] = True
    every = load_reader("sv_per_s")(run)
    assert every == pytest.approx(1.5)
    assert load_reader("sv_per_s")(multigrmpy_run()) < every


def test_readers_read_nothing_of_a_realign_run():
    run = {"driver": "realign", "window_s": 20.0, "reads": 1000,
           "rounds": 4, "scorer": {}, "trace": {"busy_s": 5.0}}
    assert [load_reader(m)(run) for m in READERS] == [None] * len(READERS)


def test_stage_readers_read_nothing_off_the_pipelined_path():
    run = multigrmpy_run()
    for job in run["jobs"]:
        job["stage_s"] = {k: v for k, v in job["stage_s"].items()
                          if k in stages.ENTRY}  # the batch path's stages
    assert load_reader("graph_build_ms_per_sv.catalog1k")(run) is None
    assert load_reader("extract_wait_ms_per_sv.catalog1k")(run) is None
    assert load_reader("entry_ms_per_sv.catalog1k")(run) is not None


def test_readers_agree_with_the_split_on_mixed_paths():
    """Job 2 on the batch path: graph_build is job 1's 1 s over both
    completed jobs' 20 events, 50 ms, as on the detail line."""
    run = multigrmpy_run()
    job2 = run["jobs"][1]["stage_s"]
    run["jobs"][1]["stage_s"] = {k: v for k, v in job2.items()
                                 if k in stages.ENTRY}
    split = stages.split(run["jobs"], run["events"])
    assert load_reader("graph_build_ms_per_sv.catalog1k")(run) == (
        pytest.approx(50.0))
    assert split["graph_build"] == pytest.approx(50.0)
    for metric, names in ((READERS[1], stages.ENTRY),
                          (READERS[3], stages.WORKERS)):
        assert load_reader(metric)(run) == pytest.approx(
            sum(split[k] for k in names if k in split))
