"""The port's per-event path on the CPU against the JAX package.

grmpy per event (batch_events=False) and the `paragraph` CLI score each
(event x sample) through two single-graph fills, one per graph
orientation. On a make_workload run the port (device="cpu": the plain
PyTorch fill) must give the JAX package's genotypes and paragraph JSON,
apart from the `engine` marker that names the scoring engine; the
scorers' stats must reach `kernel_stats`; and the self-scoring aligner
must go through SingleGraphSW, never the paired scorer.
"""
import copy
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


def _strip_engine(obj):
    if isinstance(obj, dict):
        return {k: _strip_engine(v) for k, v in obj.items() if k != "engine"}
    if isinstance(obj, list):
        return [_strip_engine(v) for v in obj]
    return obj


def _same_apart_from_engine(a, b):
    # NaN rates appear in the records: compare the serialised forms
    return (json.dumps(_strip_engine(a), sort_keys=True)
            == json.dumps(_strip_engine(b), sort_keys=True))


def _engines(obj):
    if isinstance(obj, dict):
        found = {obj["engine"]} if "engine" in obj else set()
        for v in obj.values():
            found |= _engines(v)
        return found
    if isinstance(obj, list):
        return set().union(*map(_engines, obj)) if obj else set()
    return set()


@pytest.fixture(scope="module")
def wl3(tmp_path_factory):
    from make_workload import generate

    from paragraph_tpu.pipeline.multigrmpy import (MultigrmpyOptions,
                                                   load_graph_description)

    wl = str(tmp_path_factory.mktemp("wl3"))
    generate(wl, n_events=3, depth=10, seed=3)
    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, "graphs"))
    graphs = load_graph_description(opts)
    assert len(graphs) == 3
    return wl, opts, graphs


def test_per_event_grmpy_matches_jax_package(wl3):
    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.pipeline.grmpy import run_grmpy as jax_run_grmpy
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy

    wl, opts, graphs = wl3
    want = jax_run_grmpy(copy.deepcopy(graphs), opts.reference,
                         load_manifest(opts.manifest), None,
                         GrmpyParameters(threads=1), batch_events=False)
    stats = {}
    got = run_grmpy(copy.deepcopy(graphs), opts.reference,
                    load_manifest(opts.manifest), None,
                    GrmpyParameters(threads=1), batch_events=False,
                    device="cpu", kernel_stats=stats)
    assert _same_apart_from_engine(got, want)
    assert _engines(got) == {"torch"}
    # one sample, reads at every event: a fill per graph orientation
    assert stats["dispatches"] == 2 * len(graphs)
    assert stats["cells"] > 0 and stats["lanes"] > 0
    assert set(stats) >= {"device_wait_s", "tables_s", "put_s", "call_s"}
    # the cross-event batch path (the paired fill) gives the same genotypes
    batch = run_grmpy(copy.deepcopy(graphs), opts.reference,
                      load_manifest(opts.manifest), None,
                      GrmpyParameters(threads=1), batch_events=True,
                      device="cpu")
    assert _engines(batch) == {"precomputed"}
    assert _same_apart_from_engine(got, batch)


def _paragraph_args(wl, graph_path, out):
    return ["paragraph", "-b", os.path.join(wl, "sample.bam"), "-g",
            graph_path, "-r", os.path.join(wl, "ref.fa"), "-o", out]


def test_paragraph_cli_matches_jax_package(wl3, tmp_path):
    from paragraph_tpu.cli.main import main as jax_main
    from paragraph_tpu_torch.cli.main import main

    wl, _, graphs = wl3
    graph_path = str(tmp_path / "event.json")
    with open(graph_path, "w") as f:
        json.dump(graphs[0], f)
    jax_out, port_out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jax_main(_paragraph_args(wl, graph_path, jax_out)) == 0
    assert main(_paragraph_args(wl, graph_path, port_out)
                + ["--device", "cpu"]) == 0
    with open(jax_out) as f:
        want = json.load(f)
    with open(port_out) as f:
        got = json.load(f)
    assert got["alignment_statistics"]["engine"] == "torch"
    assert _same_apart_from_engine(got, want)
    assert got["read_counts_by_node"]


_NO_JAX_SCRIPT = r"""
import sys
sys.modules["jax"] = None
from paragraph_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
assert not any(m == "jax" or m.startswith("jax.")
               for m, v in sys.modules.items() if v is not None), "jax loaded"
sys.exit(rc)
"""


def test_paragraph_cli_runs_without_jax(wl3, tmp_path):
    from paragraph_tpu_torch.cli.main import main

    wl, _, graphs = wl3
    graph_path = str(tmp_path / "event.json")
    with open(graph_path, "w") as f:
        json.dump(graphs[1], f)
    in_process = str(tmp_path / "in_process.json")
    assert main(_paragraph_args(wl, graph_path, in_process)
                + ["--device", "cpu"]) == 0
    out = str(tmp_path / "nojax.json")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT,
         *_paragraph_args(wl, graph_path, out), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f, open(in_process) as g:
        assert f.read() == g.read()


def test_paragraph_cli_on_cuda_without_a_card_raises(wl3, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path runs instead")
    from paragraph_tpu_torch.cli.main import main

    wl, _, graphs = wl3
    graph_path = str(tmp_path / "event.json")
    with open(graph_path, "w") as f:
        json.dump(graphs[0], f)
    out = str(tmp_path / "cuda.json")
    with pytest.raises(RuntimeError, match="cuda"):
        main(_paragraph_args(wl, graph_path, out) + ["--device", "cuda"])
    assert not os.path.exists(out)


def _aligner_case():
    from paragraph_tpu.graph.model import SequenceGraph
    from paragraph_tpu.reads.read import Read

    g = SequenceGraph(
        ["LF", "MID", "INS", "RF"],
        ["ACGTACGTACGTACGTACGT", "TTTTCCCCGGGG", "GATTACAGAT",
         "TGCATGCATGCATGCATGCA"])
    for f, t in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        g.add_edge(f, t)
    reads = [Read(fragment_id=f"r{i}", bases=b) for i, b in enumerate([
        "ACGTACGTACGTACGTACGTTTTTCCCCGGGG", "GGGGTGCATGCATGCA",
        "ATCTGTAATCACGTACGT", "TTTTTTTTTTTTTT", "NNNNNN", "CCCC", "",
        "TGCATGCATGCATGCATGCAGATTACA", "acgtacgtacgtGATTACAGATtgca"])]
    return g, reads


@pytest.mark.parametrize("trace_uniq_only", [False, True])
def test_self_scoring_aligner_uses_the_single_graph_fill(trace_uniq_only,
                                                         monkeypatch):
    from paragraph_tpu.align.composite import align_reads as jax_align
    from paragraph_tpu_torch.align.composite import align_reads
    from paragraph_tpu_torch.ops import multi_sw, pallas_sw

    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("the paired scorer was constructed")

    monkeypatch.setattr(multi_sw, "PairedGraphSW", Refused)
    built = []
    real_init = pallas_sw.SingleGraphSW.__init__

    def spy(self, graph, *args, **kwargs):
        built.append(graph)
        real_init(self, graph, *args, **kwargs)

    monkeypatch.setattr(pallas_sw.SingleGraphSW, "__init__", spy)
    g, reads = _aligner_case()
    want_reads = copy.deepcopy(reads)
    got_reads = copy.deepcopy(reads)
    stats, kernel_stats = {}, {}
    want = jax_align(g, [], want_reads, None, False, True, False, False,
                     trace_uniq_only=trace_uniq_only)
    got = align_reads(g, [], got_reads, None, False, True, False, False,
                      trace_uniq_only=trace_uniq_only, stats_out=stats,
                      device="cpu", kernel_stats=kernel_stats)
    assert stats["engine"] == "torch"
    # the forward graph and its reversal
    assert [b.node_seqs for b in built] == [g.node_seqs,
                                            g.reversed().node_seqs]
    assert kernel_stats["dispatches"] == 2
    assert kernel_stats["lanes"] == 2 * pallas_sw.TILE_LANES
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        for attr in ("bases", "quals", "graph_pos", "graph_cigar",
                     "graph_mapq", "graph_alignment_score",
                     "is_graph_alignment_unique",
                     "is_graph_reverse_strand", "graph_mapping_status"):
            assert getattr(a, attr) == getattr(b, attr), (a.fragment_id,
                                                          attr)
