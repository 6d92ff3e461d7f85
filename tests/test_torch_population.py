"""A population run of the port on the CPU: the device genotyping engine.

One make_workload run of 8 events and 4 samples (depth 10, seed 9), so
that gt_engine="auto" resolves to the float32 device engine. The port's
batch path (threads=1) and pipelined path (threads=2) on device="cpu"
must both take that engine, agree with each other exactly, and agree with
the JAX package's gt_engine="device" run within float32 tolerance
(test_torch_device_engine.py states the tolerances); their confident
calls must equal the port's float64 host engine's. The per-event path
(batch_events=False) on the same run must complete, genotype on the host
(its output is the host engine's) and equal the JAX package's per-event
run bit for bit.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_device_engine import (GL_ATOL, GL_RTOL, _gq_resolved,
                                      _near_boundary)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

FLOAT_KEYS = ("coverage_test_pvalue",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run_inputs(tmp_path_factory):
    """(graph descriptions, reference, manifest path) of the workload."""
    from make_workload import generate

    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    wl = str(tmp_path_factory.mktemp("wl_pop"))
    generate(wl, n_events=8, depth=10, seed=9, n_samples=4)
    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"), output=wl)
    graphs = load_graph_description(opts)
    assert len(graphs) >= 8
    return graphs, opts.reference, opts.manifest


def _port(run_inputs, stats=None, **kw):
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy

    graphs, ref, manifest = run_inputs
    batch_events = kw.pop("batch_events", None)
    return run_grmpy(copy.deepcopy(graphs), ref, load_manifest(manifest),
                     None, GrmpyParameters(**kw), batch_events=batch_events,
                     device="cpu", kernel_stats=stats)


def _jax(run_inputs, **kw):
    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.pipeline.grmpy import GrmpyParameters, run_grmpy

    graphs, ref, manifest = run_inputs
    batch_events = kw.pop("batch_events", None)
    return run_grmpy(copy.deepcopy(graphs), ref, load_manifest(manifest),
                     None, GrmpyParameters(**kw), batch_events=batch_events)


@pytest.fixture(scope="module")
def port_batch(run_inputs):
    stats = {}
    results = _port(run_inputs, stats, threads=1)
    return results, stats


def _compare_genotype(got, want, where, counts):
    """One genotype record ("GT", "GL", "GQ", filters, ...): floats within
    float32 tolerance, decisions equal unless JAX's record lies at a
    decision boundary (test_torch_device_engine.py's rules)."""
    assert set(got) == set(want), where
    if "GL" in want:
        assert list(got["GL"]) == list(want["GL"]), where
        np.testing.assert_allclose(list(got["GL"].values()),
                                   list(want["GL"].values()), rtol=GL_RTOL,
                                   atol=GL_ATOL, err_msg=where)
    for k in FLOAT_KEYS:
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=where)
    if "allele_fractions" in want:
        assert got["allele_fractions"] == pytest.approx(
            want["allele_fractions"], rel=1e-6), where
    decisions = [k for k in want
                 if k not in ("GL", "allele_fractions", *FLOAT_KEYS)]
    differ = [k for k in decisions if got[k] != want[k]]
    if not differ:
        return
    gl = np.asarray([list(want.get("GL", {0: 0.0}).values())])
    pv = np.asarray([want.get("coverage_test_pvalue", 0.5)])
    if _near_boundary(gl, pv)[0]:
        counts["boundary"] += 1
    elif differ == ["GQ"] and not _gq_resolved(gl)[0]:
        counts["gq_ulps"] += 1
    else:
        raise AssertionError(f"{where}: {differ} differ: {got} != {want}")


def _compare_runs(got, want):
    """Whole genotypes arrays: every field equal but the genotype
    records, which _compare_genotype holds; returns the boundary
    counts."""
    counts = {"boundary": 0, "gq_ulps": 0}

    def walk(a, b, where):
        if isinstance(b, dict) and "GT" in b:
            _compare_genotype(a, b, where, counts)
        elif isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                walk(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        else:
            assert a == b, f"{where}: {a!r} != {b!r}"

    assert len(got) == len(want)
    walk(got, want, "")
    return counts


def test_batch_path_takes_device_engine(port_batch):
    results, stats = port_batch
    assert len(results) >= 8 and stats["dispatches"] == 1
    # 8 events x 4 samples x at least one breakpoint
    assert stats["gt_device_jobs"] >= 32 and stats["gt_device_call_s"] > 0


def test_batch_path_matches_jax_device_engine(run_inputs, port_batch):
    counts = _compare_runs(port_batch[0], _jax(run_inputs, threads=1,
                                               gt_engine="device",
                                               batch_events=True))
    print(f"records at a decision boundary: {counts}")


def test_pipelined_path_takes_device_engine(run_inputs, port_batch):
    stats = {}
    piped = _port(run_inputs, stats, threads=2)
    assert stats["stage_s"]["device_genotype"] > 0
    assert stats["gt_device_jobs"] == port_batch[1]["gt_device_jobs"]
    assert json.dumps(piped, sort_keys=True) == json.dumps(
        port_batch[0], sort_keys=True)


@pytest.fixture(scope="module")
def port_per_event(run_inputs):
    stats = {}
    return _port(run_inputs, stats, threads=1, batch_events=False), stats


def test_confident_calls_equal_host_engine(port_batch, port_per_event):
    """The per-event path's genotypes are the host engine's (and equal the
    batch path's under gt_engine="host", as chip_smoke.py phase 7 holds
    on the card)."""
    host = port_per_event[0]
    n_checked = 0
    for rec_h, rec_d in zip(host, port_batch[0]):
        for name, sh in rec_h["samples"].items():
            sd = rec_d["samples"][name]
            gt_h, gt_d = sh["gt"], sd["gt"]
            if gt_h.get("GQ", 0) >= 10 and "PASS" in gt_h.get("filters", []):
                assert gt_d["GT"] == gt_h["GT"], (name, gt_h, gt_d)
                n_checked += 1
            for bp, bp_h in sh.get("breakpoints", {}).items():
                bp_d = sd["breakpoints"][bp]
                assert bp_d["counts"] == bp_h["counts"]
                if bp_h["gt"].get("GQ", 0) >= 10:
                    assert bp_d["gt"]["GT"] == bp_h["gt"]["GT"], bp
                for k, v in bp_h["gt"].get("GL", {}).items():
                    assert abs(bp_d["gt"]["GL"][k] - v) <= max(
                        5e-3, 2e-4 * abs(v)), (bp, k)
    assert n_checked >= 8


def _strip_engine(obj):
    if isinstance(obj, dict):
        return {k: _strip_engine(v) for k, v in obj.items() if k != "engine"}
    if isinstance(obj, list):
        return [_strip_engine(v) for v in obj]
    return obj


def test_per_event_path_runs_on_the_host_engine(port_per_event):
    """batch_events=False with >= 4 samples and >= 8 events: the port used
    to refuse it; it scores per event and genotypes on the host, as the
    JAX package does."""
    results, stats = port_per_event
    assert len(results) >= 8
    assert "gt_device_jobs" not in stats and stats["dispatches"] > 0


def test_per_event_path_matches_jax(run_inputs, port_per_event):
    want = _jax(run_inputs, threads=1, batch_events=False)
    assert json.dumps(_strip_engine(port_per_event[0]),
                      sort_keys=True) == json.dumps(_strip_engine(want),
                                                    sort_keys=True)
