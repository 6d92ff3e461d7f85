"""The PyTorch port stands alone: it imports neither jax nor the JAX package.

A static scan of every import statement (function bodies included) in
the port's modules and in chip_smoke.py, and a subprocess whose import
system refuses ``jax`` and ``paragraph_tpu``: it imports every module of
the port, runs the ablation harness's plain fill on a tiny case, a
2-event grmpy and the ``paragraph`` tool on the CPU over a workload made
by the repo's generator (in this process, since the generator uses the
JAX package's BGZF reader), and checks that the outputs came back.
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
FORBIDDEN = ("jax", "paragraph_tpu")


def _sources():
    return sorted((ROOT / "paragraph_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden_imports(path: Path):
    """(line, module) of every absolute import of jax or paragraph_tpu."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
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
                     "import paragraph_tpu_torch\n")
    assert _forbidden_imports(probe) == [(4, "jax.numpy"),
                                         (5, "paragraph_tpu.io")]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert _forbidden_imports(path) == []


_ISOLATED = r"""
import importlib, importlib.abc, json, pkgutil, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "paragraph_tpu"):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
wl, graph_a, graph_b, out_dir = sys.argv[1:]

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
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "paragraph_tpu"))
print(json.dumps({"modules": len(names), "fills": fills,
                  "loaded": loaded}))
"""


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from make_workload import generate

    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    wl = tmp_path_factory.mktemp("wl_isolated")
    generate(str(wl), n_events=2, depth=10, seed=4)
    graphs = load_graph_description(MultigrmpyOptions(
        input=str(wl / "candidates.vcf"), reference=str(wl / "ref.fa"),
        output=str(wl / "graphs")))
    assert len(graphs) == 2
    paths = []
    for i, graph in enumerate(graphs):
        paths.append(wl / f"event{i}.json")
        paths[-1].write_text(json.dumps(graph))
    return wl, paths


def test_port_runs_with_jax_and_the_jax_package_refused(workload, tmp_path):
    wl, (graph_a, graph_b) = workload
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED, str(wl), str(graph_a),
         str(graph_b), str(tmp_path)],
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
