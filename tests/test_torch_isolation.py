"""The PyTorch port stands alone: it imports neither jax nor the JAX package.

A static scan of every import statement (function bodies included) in
the port's modules, in chip_smoke.py and in the multi-host worker
(tests/test_torch_multihost.py, its tests left out) for ``jax``,
``paragraph_tpu`` and the JAX project's root bench scripts (``bench``,
``bench_e2e``, ``bench_population``), and a subprocess whose import
system refuses all five: it imports every module of the
port, runs the ablation harness's plain fill on a tiny case, a 2-event
grmpy, the ``paragraph``, ``idxdepth``, ``vcf2paragraph`` and
``multiparagraph`` tools, the sharded scorer on a 2-entry mesh, the edge
count merge, graft_entry.entry under the profiling hook, the host
profiler, the multi-host worker (a group of one), the end-to-end bench
harness with its scoring and the population scoring, and the cells/s
harness's bench_device on the plain fill, on the CPU over a
workload made by the repo's generator (in this process, since the
generator uses the JAX package's BGZF reader), and checks that the
outputs came back.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

ROOT = Path(__file__).resolve().parent.parent
#: jax, the JAX package and the JAX project's root bench scripts, whose
#: scoring the port keeps its own copy of (tools/bench*.py)
FORBIDDEN = ("jax", "paragraph_tpu", "bench", "bench_e2e",
             "bench_population")


def _sources():
    return sorted((ROOT / "paragraph_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden_imports(path: Path, skip_tests: bool = False):
    """(line, module) of every absolute import of a FORBIDDEN root; with
    `skip_tests`, outside the bodies of the test_* functions."""
    tree = ast.parse(path.read_text(), str(path))
    if skip_tests:
        tree.body = [n for n in tree.body if not (
            isinstance(n, ast.FunctionDef) and n.name.startswith("test_"))]
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                found.append((node.lineno, name))
    return found


def test_scan_finds_the_imports_it_looks_for(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom . import x\n"
                     "def f():\n    import jax.numpy\n"
                     "    from paragraph_tpu.io import bam\n"
                     "    from bench_e2e import check_truth\n"
                     "import paragraph_tpu_torch\n"
                     "from paragraph_tpu_torch.tools import bench\n")
    assert _forbidden_imports(probe) == [(4, "jax.numpy"),
                                         (5, "paragraph_tpu.io"),
                                         (6, "bench_e2e")]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert _forbidden_imports(path) == []


def test_multihost_worker_imports_neither():
    """tests/test_torch_multihost.py is also the multi-host worker: apart
    from its tests, which compare with the JAX package, it imports
    neither."""
    path = ROOT / "tests" / "test_torch_multihost.py"
    assert _forbidden_imports(path, skip_tests=True) == []
    assert _forbidden_imports(path) != []


_ISOLATED = r"""
import importlib, importlib.abc, json, pkgutil, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "paragraph_tpu", "bench",
                                  "bench_e2e", "bench_population"):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
wl, graph_a, graph_b, events, out_dir = sys.argv[1:]

import paragraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paragraph_tpu_torch.__path__, "paragraph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.tools import kbench2

g = SequenceGraph(["a", "b", "c"], ["ACGTACGTAC", "GGATC", "TTAGCATG"])
for f, t in ((0, 1), (0, 2), (1, 2)):
    g.add_edge(f, t)
a = msw.MultiGraphArrays([g, g.reversed()])
host = msw.build_pair_tables(a, [["ACGTGGATCTTAG", "TAGCATG"]],
                             msw.TILE_LANES)
tables = kbench2.expanded_tables(msw.tables_from_numpy(host, a, "cpu"))
fills = {v: kbench2.kbench_fill_reference(tables, v)[0, :2].tolist()
         for v in ("v0", "opt2_nof")}

from paragraph_tpu_torch.cli.main import main
grmpy_out = f"{out_dir}/grmpy.json"
assert main(["grmpy", "-r", f"{wl}/ref.fa", "-g", graph_a, graph_b,
             "-m", f"{wl}/samples.txt", "-o", grmpy_out,
             "--device", "cpu"]) == 0
paragraph_out = f"{out_dir}/paragraph.json"
assert main(["paragraph", "-b", f"{wl}/sample.bam", "-g", graph_a, "-r",
             f"{wl}/ref.fa", "-o", paragraph_out, "--device", "cpu"]) == 0
assert main(["idxdepth", "-b", f"{wl}/sample.bam", "-r", f"{wl}/ref.fa",
             "-o", f"{out_dir}/idxdepth.json",
             "--autosome-regex", "chrS"]) == 0
assert main(["vcf2paragraph", f"{wl}/candidates.vcf",
             f"{out_dir}/vcf2paragraph.json", "-r", f"{wl}/ref.fa"]) == 0
assert main(["multiparagraph", events, "-b", f"{wl}/sample.bam", "-r",
             f"{wl}/ref.fa", "-o", f"{out_dir}/multiparagraph.json",
             "--device", "cpu"]) == 0
import os
import torch
from paragraph_tpu_torch import graft_entry
from paragraph_tpu_torch.parallel.distributed import ShardedPairedSW
from paragraph_tpu_torch.parallel.mesh import merged_edge_counts
from paragraph_tpu_torch.tools import prof_host
from paragraph_tpu_torch.utils import profiling

cpu = torch.device("cpu")
sharded = ShardedPairedSW([g, g], [cpu] * 2).score_pairs(
    [["ACGTGGATCTTAG"], ["TAGCATG"]])
fn, args = graft_entry.entry("cpu")
os.environ[profiling.ENV_VAR] = f"{out_dir}/profile"
with profiling.maybe_profile("isolated"):
    entry_scores = fn(*args)[0]
del os.environ[profiling.ENV_VAR]
assert prof_host.main(["--events", "2", "--workload", wl, "--device",
                       "cpu"]) == 0
sys.path.insert(0, "tests")
import test_torch_multihost
assert test_torch_multihost.worker(
    [f"file://{out_dir}/rdv", "0", "1", wl, f"{out_dir}/multihost.json",
     "cpu"]) == 0
from paragraph_tpu_torch.tools import bench, bench_e2e, bench_population
assert bench_e2e.main(["--events", "2", "--workload", wl, "--device",
                       "cpu"]) == 0
with open(f"{wl}/truth.json") as f:
    truth = json.load(f)
n_ok, misses = bench_e2e.check_truth(f"{wl}/out_bench/genotypes.vcf.gz",
                                     f"{wl}/out_bench/genotypes.json.gz",
                                     truth)
recall = bench_e2e.per_kind_recall(truth, misses)
pop = bench_population.score_population(
    f"{wl}/out_bench/genotypes.vcf.gz", truth, ["sample"])
bench_g, bench_reads = bench.build_case(read_len=30, n_reads=4)
cells_per_s, _ = bench.bench_device(bench_g, bench_reads, repeats=1,
                                    device="cpu")
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "paragraph_tpu", "bench",
                                        "bench_e2e", "bench_population"))
print(json.dumps({"modules": len(names), "fills": fills,
                  "loaded": loaded,
                  "sharded": [int(p[0][0].max()) for p in sharded],
                  "edges": merged_edge_counts(
                      [cpu] * 2, [[1, 0], [1, 1]]).tolist(),
                  "entry_min": int(entry_scores.min()),
                  "traces": len(os.listdir(f"{out_dir}/profile/isolated")),
                  "bench": [n_ok, sorted(recall), pop, cells_per_s > 0]}))
"""


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from make_workload import generate
    from test_torch_tools import multiparagraph_events

    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    wl = tmp_path_factory.mktemp("wl_isolated")
    truth = generate(str(wl), n_events=2, depth=10, seed=4)
    assert [ev["kind"] for ev in truth] == ["DEL", "INS"]
    events = wl / "events.json"
    events.write_text(json.dumps(multiparagraph_events(truth)))
    graphs = load_graph_description(MultigrmpyOptions(
        input=str(wl / "candidates.vcf"), reference=str(wl / "ref.fa"),
        output=str(wl / "graphs")))
    assert len(graphs) == 2
    paths = []
    for i, graph in enumerate(graphs):
        paths.append(wl / f"event{i}.json")
        paths[-1].write_text(json.dumps(graph))
    return wl, paths, events


def test_port_runs_with_jax_and_the_jax_package_refused(workload, tmp_path):
    wl, (graph_a, graph_b), events = workload
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED, str(wl), str(graph_a),
         str(graph_b), str(events), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["loaded"] == []
    assert summary["modules"] >= 60
    assert summary["fills"]["v0"][0] > 0
    genotypes = json.loads((tmp_path / "grmpy.json").read_text())
    assert len(genotypes) == 2 and all("samples" in r for r in genotypes)
    paragraph = json.loads((tmp_path / "paragraph.json").read_text())
    assert paragraph["alignment_statistics"]["engine"] == "torch"
    depth = json.loads((tmp_path / "idxdepth.json").read_text())
    assert depth["autosome"]["contigs"] == ["chrS"]
    graph = json.loads((tmp_path / "vcf2paragraph.json").read_text())
    assert graph["nodes"] and graph["paths"]
    per_event = json.loads((tmp_path / "multiparagraph.json").read_text())
    assert [e["type"] for e in per_event] == ["del", "ins"]
    assert all(e["graph"]["alignment_statistics"]["engine"] == "torch"
               for e in per_event)
    assert summary["sharded"] == [9, 7]
    assert summary["edges"] == [2, 1]
    assert summary["entry_min"] > 0 and summary["traces"] == 1
    merged = json.loads((tmp_path / "multihost.json").read_text())
    assert len(merged) == 2 and all("samples" in r for r in merged)
    # the bench harnesses' scoring on their own 2-event run, and K1's
    # bench case on the plain fill
    assert summary["bench"] == [2, ["DEL", "INS"], [2, 2], True]
