"""The port's bench harnesses against the repository's root bench scripts.

paragraph_tpu_torch/tools/{bench_e2e,bench_population,bench}.py keep
the root scripts' command lines, output keys and scoring. Here:
check_truth, per_kind_recall and score_population equal the root
scripts' functions on the outputs of small port runs on the CPU (each
harness's main at a tiny size) and on hand-made VCF and JSON rows that
hit every miss class, the GQ derived from PL and the DEL+SNP UNMATCHED
rule; bench_device's cell count equals the JAX bench's formula on the
JAX scorer's columns; the device worker's watchdog never falls back to
the CPU; and a --device cpu line is marked failed.
"""
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

import bench as jax_bench
import bench_e2e as jax_e2e
import bench_population as jax_pop
from paragraph_tpu.ops.multi_sw import PairedGraphSW as JaxPairedGraphSW
from paragraph_tpu_torch.tools import bench, bench_e2e, bench_population

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "tools"))

from make_workload import generate  # noqa: E402

#: the small runs: events and depth of the end-to-end workload (its kinds
#: cycle DEL, INS, DUP, INV, DELSNP), and of the population one
E2E_EVENTS, E2E_DEPTH, E2E_SEED = 5, 6, 3
POP_EVENTS, POP_SAMPLES, POP_DEPTH, POP_SEED = 2, 4, 6, 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each
    other. One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _json_lines(text: str):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    """bench_e2e.main on the CPU over a small workload made here: (events,
    the run's stdout line, its stderr JSON lines, its output dir)."""
    wl = tmp_path_factory.mktemp("bench_e2e")
    events = generate(str(wl), n_events=E2E_EVENTS, depth=E2E_DEPTH,
                      seed=E2E_SEED)
    assert [e["kind"] for e in events] == ["DEL", "INS", "DUP", "INV",
                                           "DELSNP"]
    proc = subprocess.run(
        [sys.executable, "-m", "paragraph_tpu_torch.tools.bench_e2e",
         "--events", str(E2E_EVENTS), "--workload", str(wl), "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return events, _last_json(proc.stdout), _json_lines(proc.stderr), \
        wl / "out_bench"


@pytest.fixture(scope="module")
def pop_run(tmp_path_factory):
    """bench_population.main on the CPU, its workload made here at the
    harness's own path under a temporary TMPDIR: (events, samples, the
    stdout line, the detail line, the output dir)."""
    tmp = tmp_path_factory.mktemp("bench_pop_tmp")
    wl = tmp / f"bench_pop_wl{POP_EVENTS}x{POP_SAMPLES}_s{POP_SEED}"
    events = generate(str(wl), n_events=POP_EVENTS, depth=POP_DEPTH,
                      seed=POP_SEED, n_samples=POP_SAMPLES)
    proc = subprocess.run(
        [sys.executable, "-m", "paragraph_tpu_torch.tools.bench_population",
         "--events", str(POP_EVENTS), "--samples", str(POP_SAMPLES),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1",
                          "TMPDIR": str(tmp)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    detail = [d for d in _json_lines(proc.stderr)
              if "confident_accuracy" in d]
    return events, sorted(events[0]["gts"]), _last_json(proc.stdout), \
        detail[0], wl / "out_bench"


# ------------------------------------------------------ the small port runs


def test_e2e_main_on_cpu(e2e_run):
    events, line, details, _ = e2e_run
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "sv_genotyping_throughput_30x"
    assert line["unit"] == "SV/s" and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / jax_e2e.REFERENCE_SV_PER_S, 2)
    detail = details[0]
    assert set(detail) == {
        "events", "elapsed_s", "genotype_accuracy", "explained_accuracy",
        "unexpected_misses", "suspect_misses", "peak_rss_main_mb",
        "peak_rss_worker_mb", "peak_device_mb", "device", "stage_s"}
    assert detail["events"] == len(events) and detail["device"] == "cpu"
    assert detail["peak_device_mb"] is None
    assert detail["unexpected_misses"] == 0
    # fewer than 8 events: the batch path, so only the job's own stages
    assert set(detail["stage_s"]) == {"load", "write_json", "vcf_update"}
    assert set(details[1]["per_kind_recall"]) == {e["kind"] for e in events}


def test_e2e_scoring_equals_the_root_script_on_a_port_run(e2e_run):
    events, _, details, out = e2e_run
    vcf, js = out / "genotypes.vcf.gz", out / "genotypes.json.gz"
    got = bench_e2e.check_truth(vcf, js, events)
    want = jax_e2e.check_truth(vcf, js, events)
    assert got == want
    assert bench_e2e.per_kind_recall(events, got[1]) == \
        jax_e2e.per_kind_recall(events, want[1])
    assert details[1]["per_kind_recall"] == jax_e2e.per_kind_recall(
        events, want[1])


def test_population_main_on_cpu(pop_run):
    events, samples, line, detail, _ = pop_run
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "sv_sample_throughput"
    assert line["unit"] == "SV*sample/s" and line["value"] > 0
    assert set(detail) == {
        "events", "samples", "elapsed_s", "engine", "confident_calls",
        "confident_accuracy", "gt_device_jobs", "gt_device_call_s",
        "peak_device_mb", "device", "stage_s"}
    assert (detail["events"], detail["samples"]) == (len(events),
                                                     len(samples))
    assert detail["engine"] == "auto" and detail["device"] == "cpu"
    # fewer than 8 events: auto genotypes on the host
    assert detail["gt_device_jobs"] == 0
    assert detail["confident_calls"] > 0


def test_population_scoring_equals_the_root_script_on_a_port_run(pop_run):
    events, samples, _, detail, out = pop_run
    vcf = out / "genotypes.vcf.gz"
    got = bench_population.score_population(vcf, events, samples)
    assert got == jax_pop.score_population(vcf, events, samples)
    assert detail["confident_calls"] == got[0]
    assert detail["confident_accuracy"] == round(got[1] / got[0], 4)


# -------------------------------------------------------- hand-made rows

#: (event, VCF FORMAT, VCF sample column or None for no row, breakpoint
#: genotypes of the event's allele); each row names the class it hits
_E2E_ROWS = [
    ({"pos": 100, "kind": "DEL", "gt": "0/1"}, "GT:FT:GQ", "0/1:PASS:50",
     None),                                                  # ok
    ({"pos": 200, "kind": "DEL", "gt": "1/1"}, "GT:FT:GQ", "0/1:PASS:5",
     None),                                                  # low_gq
    ({"pos": 300, "kind": "INS", "gt": "0/1"}, "GT:FT:GQ",
     "1/1:CONFLICT:3", None),                                # filtered
    ({"pos": 400, "kind": "DUP", "gt": "0/1"}, "GT:FT:GQ",
     "1/1:BP_NO_GT:40", None),                               # suspect
    ({"pos": 500, "kind": "INV", "gt": "0/1"}, "GT:FT:GQ", "1/1:PASS:60",
     None),                                                  # unexpected
    ({"pos": 600, "kind": "DEL", "gt": "0/1"}, "GT:FT:GQ", "1/0:PASS:30",
     None),                                                  # ok, 1/0
    ({"pos": 700, "kind": "DEL", "gt": "0/0"}, "GT:FT:GQ", "./.:PASS:0",
     None),                                                  # ok, ./.
    ({"pos": 800, "kind": "DELSNP", "gt": "0/1"}, "GT:FT:GQ",
     ".:UNMATCHED:7", {"REF/ev7:1"}),                        # UNMATCHED ok
    ({"pos": 900, "kind": "DELSNP", "gt": "1/1"}, "GT:FT:GQ",
     ".:UNMATCHED:20", {"ev8:1/ev8:1", "REF/ev8:1"}),        # suspect
    ({"pos": 1000, "kind": "DELSNP", "gt": "0/0"}, "GT:FT:GQ",
     "0/1:PASS:45", {"REF/REF"}),                            # unexpected
    ({"pos": 1100, "kind": "DEL", "gt": "0/1"}, "GT:FT:PL",
     "1/1:PASS:200,30,0", None),                      # unexpected, GQ 30
    ({"pos": 1200, "kind": "DEL", "gt": "0/1"}, "GT:FT:PL",
     "1/1:PASS:90,4,0", None),                        # low_gq, GQ 4 by PL
    ({"pos": 1300, "kind": "INS", "gt": "0/1"}, "GT:FT:PL",
     "1/1:PASS:.", None),                             # unexpected, bad PL
    ({"pos": 1400, "kind": "INS", "gt": "1/1"}, "GT:FT:GQ", "0/1:PASS:.",
     None),                                           # unexpected, GQ .
    ({"pos": 1500, "kind": "DUP", "gt": "0/1"}, None, None,
     None),                                           # unexpected, missing
    ({"pos": 1600, "kind": "INV", "gt": "0/1"}, "GT", "1/1",
     None),                                           # unexpected, no FT
    ({"pos": 1700, "kind": "DEL", "gt": "0/1"}, "GT:GQ", "0/0:8",
     None),                                           # low_gq, no FT
]


def _write_e2e_rows(tmp_path):
    vcf = tmp_path / "rows.vcf.gz"
    js = tmp_path / "rows.json.gz"
    records = []
    with gzip.open(vcf, "wt") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tsample\n")
        for i, (ev, fmt, col, bp_gts) in enumerate(_E2E_ROWS):
            if fmt is not None:
                f.write(f"chrS\t{ev['pos']}\tev{i}\tA\tC\t.\tPASS\t.\t{fmt}"
                        f"\t{col}\n")
            bps = {f"bp{k}": {"counts": {"alleles": ["REF", f"ev{i}:1"]},
                              "gt": {"GT": gt}}
                   for k, gt in enumerate(sorted(bp_gts or ()))}
            sample = {"breakpoints": bps} if bps else {}
            records.append({"samples": {"sample": sample}})
    with gzip.open(js, "wt") as f:
        json.dump(records, f)
    return vcf, js, [ev for ev, *_ in _E2E_ROWS]


def test_check_truth_hits_every_miss_class(tmp_path):
    vcf, js, events = _write_e2e_rows(tmp_path)
    got = bench_e2e.check_truth(vcf, js, events)
    assert got == jax_e2e.check_truth(vcf, js, events)
    n_ok, misses = got
    assert n_ok == 4
    assert {m["event"]: m["reason"] for m in misses} == {
        1: "low_gq", 2: "filtered", 3: "suspect", 4: "unexpected",
        8: "suspect", 9: "unexpected", 10: "unexpected", 11: "low_gq",
        12: "unexpected", 13: "unexpected", 14: "unexpected",
        15: "unexpected", 16: "low_gq"}
    by_event = {m["event"]: m for m in misses}
    assert by_event[10]["GQ"] == 30 and by_event[11]["GQ"] == 4
    assert by_event[12]["GQ"] == -1 and by_event[14]["got"] == "missing"
    recall = bench_e2e.per_kind_recall(events, misses)
    assert recall == jax_e2e.per_kind_recall(events, misses)
    assert recall["DELSNP"] == {"total": 3, "ok": 1, "suspect": 1,
                                "unexpected": 1, "recall": 0.3333}


def test_score_population_on_hand_made_rows(tmp_path):
    vcf = tmp_path / "pop.vcf.gz"
    samples = ["s1", "s2", "s3"]
    rows = [
        (100, "GT:FT", ["0/1:PASS", "1/1:PASS", "0/0:."]),
        (200, "GT:FT", ["1/0:PASS", "./.:PASS", "1/1:CONFLICT"]),
        (300, "GT", ["0/1", "0/1", "1/1"]),
        (400, "GT:FT:GQ", ["1/1:GQ:3", "0/1:PASS:40", "0/1::12"]),
    ]
    with gzip.open(vcf, "wt") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(samples) + "\n")
        for pos, fmt, cols in rows:
            f.write(f"chrS\t{pos}\t.\tA\tC\t.\tPASS\t.\t{fmt}\t"
                    + "\t".join(cols) + "\n")
    events = [
        {"pos": 100, "gt": "0/1", "gts": {"s1": "0/1", "s2": "1/1",
                                          "s3": "0/1"}},
        {"pos": 200, "gt": "0/1", "gts": {"s1": "0/1", "s2": "0/0",
                                          "s3": "1/1"}},
        {"pos": 300, "gt": "0/1"},                  # no gts: gt for all
        {"pos": 400, "gt": "0/1", "gts": {"s2": "0/1"}},
        {"pos": 500, "gt": "1/1", "gts": {"s1": "1/1"}},   # no row
    ]
    for names in (samples, ["s2", "s4"]):
        got = bench_population.score_population(vcf, events, names)
        assert got == jax_pop.score_population(vcf, events, names)
    assert bench_population.score_population(vcf, events, samples) == (
        13, 8)


# ------------------------------------------------------------- bench.py


def _main_line(capsys, argv):
    rc = bench.main(argv)
    return rc, _last_json(capsys.readouterr().out)


@pytest.mark.parametrize("tool", ["bench", "bench_e2e", "bench_population"])
def test_harness_runs_by_path(tool):
    """Each harness runs by path from the checkout, with the root
    script's flags plus --device and, for bench.py, no others."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "paragraph_tpu_torch", "tools",
                                      f"{tool}.py"), "--help"],
        cwd=tempfile.gettempdir(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"usage: {tool}" in proc.stdout and "--device" in proc.stdout
    if tool == "bench":
        assert "--reads" not in proc.stdout


def test_bench_device_counts_cells_as_the_jax_bench():
    g, reads = bench.build_case(read_len=30, n_reads=16)
    jg, jreads = jax_bench.build_case(read_len=30, n_reads=16)
    assert reads == jreads
    a = JaxPairedGraphSW([jg]).chunk_arrays[0]
    m = ((max(len(r) for r in jreads) + 31) // 32) * 32
    want = len(jreads) * 2 * (a.col_len[0] + a.col_len[1]) * m

    from paragraph_tpu_torch.ops.multi_sw import PairedGraphSW

    assert bench.paired_cells(PairedGraphSW([g], device="cpu"),
                              reads) == want
    rate, secs = bench.bench_device(g, reads, repeats=1, device="cpu")
    assert rate > 0 and secs > 0
    assert rate * secs == pytest.approx(want, rel=1e-9)


def _worker_in_process(n_reads):
    """A stand-in for subprocess.run that runs the device worker's argv
    in this process at `n_reads` reads; records each argv."""
    calls = []

    def run(argv, **kwargs):
        calls.append(argv)
        device = argv[argv.index("--device") + 1]
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.device_worker(device, n_reads=n_reads)
        return subprocess.CompletedProcess(argv, rc, out.getvalue(),
                                           err.getvalue())

    return run, calls


def test_bench_main_on_cpu_is_marked_failed(monkeypatch, capsys):
    """--device cpu runs the worker on the plain fill (here in process at
    16 reads); the line says so, carries the keys of the root script's
    line and exits 1."""
    run, calls = _worker_in_process(16)
    monkeypatch.setattr(subprocess, "run", run)
    rc, out = _main_line(capsys, ["--device", "cpu"])
    assert rc == 1
    assert calls == [[sys.executable, os.path.abspath(bench.__file__),
                      "--device-worker",
                      "--device", "cpu"]]
    assert {"metric", "value", "unit", "vs_baseline", "path", "platform",
            "batch_reads", "dispatches", "baseline_cells_per_s", "failed",
            "failure", "kernel_stats"} == set(out)
    assert out["metric"] == "graph_sw_cells_per_second"
    assert out["path"] == "cpu" and out["platform"] == "cpu"
    assert out["failed"] is True and out["value"] > 0
    assert (out["batch_reads"], out["dispatches"]) == (16, bench.CPU_REPEATS)
    # no gssw sources: no baseline, so no gate either
    assert out["baseline_cells_per_s"] == 0.0 and out["vs_baseline"] == 0.0
    assert out["kernel_stats"]["dispatches"] == 1 + bench.DEPTH
    assert "sv_genotyping_throughput_30x" not in out


def test_watchdog_timeout_fails_without_a_cpu_run(monkeypatch, capsys):
    calls = []

    def timed_out(argv, **kwargs):
        calls.append(argv)
        raise subprocess.TimeoutExpired(argv, kwargs.get("timeout"))

    monkeypatch.setattr(subprocess, "run", timed_out)
    rc, out = _main_line(capsys, [])
    assert rc == 1
    assert out["failed"] is True and out["path"] == "none"
    assert out["value"] == 0.0 and out["platform"] == "none"
    assert out["failure"] == (f"device worker timed out after "
                              f"{bench.WORKER_TIMEOUT_S} s")
    # one worker, on the card: nothing was rerun on the CPU
    assert len(calls) == 1 and calls[0][-2:] == ["--device", "cuda"]
    assert "sv_genotyping_throughput_30x" not in out


def test_worker_on_another_device_is_refused(monkeypatch, capsys):
    """A worker that reports the CPU where the card was asked for, or that
    fails, gives failed: true and value 0.0."""
    def on_cpu(argv, **kwargs):
        return subprocess.CompletedProcess(
            argv, 0, "DEVICE_RESULT 12345.0 cpu 8192 6\n",
            'KERNEL_STATS {"dispatches": 31}\n')

    monkeypatch.setattr(subprocess, "run", on_cpu)
    rc, out = _main_line(capsys, ["--device", "cuda"])
    assert rc == 1 and out["failed"] is True and out["value"] == 0.0
    assert "platform cpu" in out["failure"]

    def failed(argv, **kwargs):
        return subprocess.CompletedProcess(argv, 1, "",
                                           "RuntimeError: no card\n")

    monkeypatch.setattr(subprocess, "run", failed)
    rc, out = _main_line(capsys, [])
    assert rc == 1 and out["failed"] is True and out["value"] == 0.0
    assert out["failure"] == ("device worker exited with code 1 and no "
                              "result: RuntimeError: no card")


def test_worker_result_keeps_a_card_name_with_spaces():
    result, why = bench.parse_worker(
        "noise\nDEVICE_RESULT 6.5e11 NVIDIA H100 80GB HBM3 8192 6\n",
        'x\nKERNEL_STATS {"tables_s": 0.5}\n', 0, "cuda")
    assert why is None
    assert result == {"cells_per_s": 6.5e11,
                      "platform": "NVIDIA H100 80GB HBM3", "n_reads": 8192,
                      "dispatches": 6, "kernel_stats": {"tables_s": 0.5}}


def test_hidden_card_worker_is_refused():
    """The real worker with no card visible fails, and the parent says
    so: no CPU number."""
    proc = subprocess.run(
        [sys.executable, "-m", "paragraph_tpu_torch.tools.bench",
         "--device-worker", "--device", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    result, why = bench.parse_worker(proc.stdout, proc.stderr,
                                     proc.returncode, "cuda")
    assert result is None
    assert "torch.cuda.is_available() is false" in why


def test_harness_workloads_default_to_tmpdir(monkeypatch, tmp_path):
    """With no --workload, each harness works in $TMPDIR under the root
    script's directory name; a truth.json of the right size is reused,
    else the checkout's generator runs with the root script's arguments."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert bench_e2e.default_workload(1000, 11) == str(
        tmp_path / "bench_e2e_wl1000_s11")
    assert bench_population.default_workload(150, 8, 17) == str(
        tmp_path / "bench_pop_wl150x8_s17")
    seen = []

    def generator(argv, timeout=0):
        seen.append(argv)
        (tmp_path / "wl" / "truth.json").write_text(json.dumps(
            [{"pos": 3, "gts": {"a": "0/1"}}]))

    monkeypatch.setattr(bench_e2e, "run_generator", generator)
    monkeypatch.setattr(bench_population, "run_generator", generator)
    wl = tmp_path / "wl"
    wl.mkdir()
    (wl / "truth.json").write_text(json.dumps([{"pos": 1}, {"pos": 2}]))
    assert bench_e2e.load_events(str(wl), 2, 11) == [{"pos": 1},
                                                      {"pos": 2}]
    assert seen == []
    assert bench_e2e.load_events(str(wl), 1, 11)[0]["pos"] == 3
    assert seen[0][1:] == [str(wl), "--events", "1", "--seed", "11"]
    assert seen[0][0] == os.path.join(ROOT, "tests", "tools",
                                      "make_workload.py")
    assert bench_population.load_events(str(wl), 1, 1, 17)[0]["pos"] == 3
    assert len(seen) == 1
    bench_population.load_events(str(wl), 1, 2, 17)
    assert seen[1][0] == "-c" and seen[1][2:] == [
        os.path.join(ROOT, "tests", "tools"), str(wl), "1", "17", "2"]
