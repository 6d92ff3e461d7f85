"""The port's multigrmpy slice end to end on the CPU.

The JAX package's multigrmpy (threads=1: the batch path) and the port's
(device="cpu": the plain PyTorch fill) must write byte-identical
genotypes JSON and identical VCF records on a make_workload run; the
port's pipelined orchestrator must agree with its batch path; the port
must run with jax unimportable; and device="cuda" without a card must
raise rather than fall back.
"""
import copy
import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other
    (a plain-fill test that takes 8 s alone took 200 s beside another).
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(wl, out, threads=1, jax=False):
    """The options of a run on the workload in `wl`, as the JAX package's
    MultigrmpyOptions when `jax`, else as the port's."""
    if jax:
        from paragraph_tpu.pipeline.multigrmpy import MultigrmpyOptions
    else:
        from paragraph_tpu_torch.pipeline.multigrmpy import MultigrmpyOptions

    return MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=out, threads=threads)


def _outputs(out_dir):
    with gzip.open(os.path.join(out_dir, "genotypes.json.gz"), "rb") as f:
        js = f.read()
    with gzip.open(os.path.join(out_dir, "genotypes.vcf.gz"), "rt") as f:
        records = [line for line in f if not line.startswith("#")]
    return js, records


@pytest.fixture(scope="module")
def wl3(tmp_path_factory):
    from make_workload import generate

    wl = str(tmp_path_factory.mktemp("wl3"))
    generate(wl, n_events=3, depth=10, seed=3)
    return wl


@pytest.fixture(scope="module")
def jax_outputs(wl3):
    from paragraph_tpu.pipeline.multigrmpy import run

    out = os.path.join(wl3, "jax")
    run(_options(wl3, out, jax=True))
    return _outputs(out)


def test_slice_matches_jax_package(wl3, jax_outputs):
    from paragraph_tpu_torch.pipeline.multigrmpy import run

    out = os.path.join(wl3, "torch_cpu")
    stats = {}
    result = run(_options(wl3, out), device="cpu", kernel_stats=stats)
    assert result["genotypes_vcf"].startswith(out)
    js, records = _outputs(out)
    assert js == jax_outputs[0]
    assert records == jax_outputs[1] and len(records) == 3
    assert stats["dispatches"] == 1 and stats["cells"] > 0
    engines = {s["alignment_statistics"]["engine"]
               for rec in json.loads(js) for s in rec["samples"].values()
               if "alignment_statistics" in s}
    assert engines <= {"precomputed"}


_NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["paragraph_tpu"] = None
import paragraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paragraph_tpu_torch.__path__, "paragraph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from paragraph_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
assert not any(m == "jax" or m.startswith("jax.")
               for m, v in sys.modules.items() if v is not None), "jax loaded"
print("modules", len(names))
sys.exit(rc)
"""


def test_slice_runs_without_jax(wl3, jax_outputs, tmp_path):
    out = str(tmp_path / "nojax")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, "multigrmpy",
         "-i", os.path.join(wl3, "candidates.vcf"),
         "-m", os.path.join(wl3, "samples.txt"),
         "-r", os.path.join(wl3, "ref.fa"), "-o", out, "-t", "1",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout
    assert _outputs(out) == jax_outputs


@pytest.fixture(scope="module")
def wl8(tmp_path_factory):
    from make_workload import generate

    wl = str(tmp_path_factory.mktemp("wl8"))
    generate(wl, n_events=8, depth=4, seed=5)
    return wl


def test_pipelined_matches_batch_path(wl8):
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        load_graph_description)
    from paragraph_tpu_torch.pipeline.parallel_grmpy import (
        run_grmpy_pipelined)

    opts = _options(wl8, os.path.join(wl8, "out"))
    graphs = load_graph_description(opts)
    assert len(graphs) >= 8
    manifest = load_manifest(opts.manifest)
    params = GrmpyParameters(threads=1)
    batch_stats, pipe_stats = {}, {}
    env_before = os.environ.get("CUDA_VISIBLE_DEVICES")
    batch = run_grmpy(copy.deepcopy(graphs), opts.reference, manifest,
                      None, params, device="cpu", kernel_stats=batch_stats)
    piped = run_grmpy_pipelined(
        copy.deepcopy(graphs), opts.reference, manifest, None, params,
        round_events=4, workers=2, device="cpu", kernel_stats=pipe_stats)
    assert json.dumps(piped, sort_keys=True) == json.dumps(batch,
                                                           sort_keys=True)
    assert batch_stats["dispatches"] == 1
    assert pipe_stats["dispatches"] == -(len(graphs) // -4)
    assert pipe_stats["cells"] > 0 and pipe_stats["lanes"] > 0
    # the card is hidden from the workers only while they are spawned
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == env_before


def test_native_library_loads_before_workers_spawn(monkeypatch):
    """Workers that race on the native library's first build fail to load
    it and trace back in Python; the parent builds it first."""
    import paragraph_tpu_torch.align.native as native
    from paragraph_tpu_torch.pipeline import parallel_grmpy
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters

    calls = []
    monkeypatch.setattr(native, "native_available",
                        lambda: calls.append("native") or True)

    def fake_pipeline(*args):
        calls.append("spawn")
        return []

    monkeypatch.setattr(parallel_grmpy, "_run_pipeline", fake_pipeline)
    assert parallel_grmpy.run_grmpy_pipelined(
        [], "", [], None, GrmpyParameters(threads=2), device="cpu") == []
    assert calls == ["native", "spawn"]


def test_workers_refuse_to_score():
    from paragraph_tpu_torch.genotyping.sample_info import SampleInfo
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters
    from paragraph_tpu_torch.pipeline.parallel_grmpy import _analyze_event

    sample = SampleInfo()
    sample.sample_name = "s"
    with pytest.raises(ValueError, match="workers do not score"):
        _analyze_event(0, {}, "", None, GrmpyParameters(),
                       [(sample, True, None)], [], 10)


def test_device_genotyping_is_not_silently_replaced():
    from paragraph_tpu_torch.pipeline.grmpy import (GrmpyParameters,
                                                    resolve_gt_engine)

    params = GrmpyParameters()
    assert resolve_gt_engine(params, 1, 1000) == "host"
    assert resolve_gt_engine(params, 4, 7) == "host"
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        resolve_gt_engine(params, 4, 8)
    with pytest.raises(NotImplementedError):
        resolve_gt_engine(GrmpyParameters(gt_engine="device"), 1, 1)


def test_cuda_without_a_card_raises(wl3, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path runs instead")
    from paragraph_tpu_torch import resolve_device
    from paragraph_tpu_torch.align.batched_aligner import BatchedGraphAligner
    from paragraph_tpu_torch.graph.model import SequenceGraph
    from paragraph_tpu_torch.ops.multi_sw import PairedGraphSW
    from paragraph_tpu_torch.pipeline.multigrmpy import run

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    g = SequenceGraph(["a"], ["ACGTACGT"])
    with pytest.raises(RuntimeError):
        PairedGraphSW([g], device="cuda")
    with pytest.raises(RuntimeError):
        BatchedGraphAligner(g, device="cuda")
    out = str(tmp_path / "cuda")
    with pytest.raises(RuntimeError):
        run(_options(wl3, out), device="cuda")
    assert not os.path.exists(os.path.join(out, "genotypes.json.gz"))


def _aligner_case(jax=False):
    """A graph and reads, of the JAX package's classes when `jax`, else
    of the port's."""
    if jax:
        from paragraph_tpu.graph.model import SequenceGraph
        from paragraph_tpu.reads.read import Read
    else:
        from paragraph_tpu_torch.graph.model import SequenceGraph
        from paragraph_tpu_torch.reads.read import Read

    g = SequenceGraph(
        ["LF", "MID", "INS", "RF"],
        ["ACGTACGTACGTACGTACGT", "TTTTCCCCGGGG", "GATTACAGAT",
         "TGCATGCATGCATGCATGCA"])
    for f, t in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        g.add_edge(f, t)
    reads = [Read(fragment_id=f"r{i}", bases=b) for i, b in enumerate([
        "ACGTACGTACGTACGTACGTTTTTCCCCGGGG", "GGGGTGCATGCATGCA",
        "ATCTGTAATCACGTACGT", "TTTTTTTTTTTTTT", "NNNNNN", "CCCC", ""])]
    return g, reads


@pytest.mark.parametrize("trace_uniq_only", [False, True])
def test_self_scoring_aligner_matches_jax(trace_uniq_only):
    from paragraph_tpu.align.composite import align_reads as jax_align
    from paragraph_tpu_torch.align.composite import align_reads

    g, got_reads = _aligner_case()
    jax_g, want_reads = _aligner_case(jax=True)
    stats = {}
    want = jax_align(jax_g, [], want_reads, None, False, True, False, False,
                     trace_uniq_only=trace_uniq_only)
    got = align_reads(g, [], got_reads, None, False, True, False, False,
                      trace_uniq_only=trace_uniq_only, stats_out=stats,
                      device="cpu")
    assert stats["engine"] == "torch"
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        for attr in ("bases", "quals", "graph_pos", "graph_cigar",
                     "graph_mapq", "graph_alignment_score",
                     "is_graph_alignment_unique",
                     "is_graph_reverse_strand", "graph_mapping_status"):
            assert getattr(a, attr) == getattr(b, attr), (a.fragment_id,
                                                          attr)
