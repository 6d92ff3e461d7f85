"""Entry points: a one-card check of the fill, and a multi-device
dry run of the pipeline.

Counterpart of the repository's ``__graft_entry__.py``. ``entry`` gives
the single-graph fill (K3, ``ops/csrc/graph_sw.cu``) on the JAX entry's
example graph and reads; the port keeps no scan engine, so K3 takes the
place of its scan fill. ``dryrun_multichip`` runs the real grmpy
pipeline over a mesh on a workload directory of
``tests/tools/make_workload.py`` (the directory is made beforehand: the
generator imports the JAX package's BGZF reader).
"""
from __future__ import annotations

import copy
import json
import os
import tempfile

import numpy as np


def _example_graph():
    """Short-deletion style graph, seeded as in __graft_entry__.py."""
    from .graph.model import SequenceGraph

    rng = np.random.RandomState(0)
    bases = "ACGT"

    def seq(n):
        return "".join(bases[i] for i in rng.randint(0, 4, n))

    g = SequenceGraph(
        ["source", "LF", "MID", "RF", "sink"],
        ["X", seq(150), seq(80), seq(150), "X"])
    for f, t in [(0, 1), (1, 2), (1, 3), (2, 3), (3, 4)]:
        g.add_edge(f, t)
    return g


def _example_reads(graph, n_reads, read_len=100, seed=1):
    rng = np.random.RandomState(seed)
    ref = graph.node_seq(1) + graph.node_seq(2) + graph.node_seq(3)
    alt = graph.node_seq(1) + graph.node_seq(3)
    reads = []
    for i in range(n_reads):
        src = ref if i % 2 == 0 else alt
        start = rng.randint(0, max(1, len(src) - read_len))
        reads.append(src[start:start + read_len])
    return reads


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) is K3's fill of the example
    graph's 64 reads on `device` ([4, 64] int32: score, end column, end
    read row, multi flag; the plain fill on the CPU)."""
    from . import resolve_device
    from .ops.batched_sw import GraphArrays, encode_reads
    from .ops.pallas_sw import (GraphFillTables, graph_fill,
                                graph_tables_from_numpy)

    graph = _example_graph()
    arrays = GraphArrays.build(graph)
    reads = _example_reads(graph, 64)
    codes, lens, vlens = encode_reads(reads)
    tables = graph_tables_from_numpy(arrays, codes.T, lens, vlens,
                                     resolve_device(device))

    def fn(ref_codes, col_node, is_start, is_last, pred_table,
           read_codes_t, read_lens, read_vlens):
        return graph_fill(GraphFillTables(
            ref_codes, col_node, is_start, is_last, pred_table,
            read_codes_t, read_lens, read_vlens))

    example_args = (tables.ref_codes, tables.col_node, tables.is_start,
                    tables.is_last, tables.pred_table, tables.read_codes_t,
                    tables.lens, tables.vlens)
    return fn, example_args


def _strip_engine(obj):
    if isinstance(obj, dict):
        return {k: _strip_engine(v) for k, v in obj.items()
                if k != "engine"}
    if isinstance(obj, list):
        return [_strip_engine(v) for v in obj]
    return obj


def dryrun_multichip(n_devices: int, workload_dir: str, mesh=None) -> dict:
    """The grmpy pipeline over an n-device mesh on the first max(8,
    2 n_devices) events of `workload_dir`'s candidates.vcf (with 8 events
    or more the batch path runs pipelined, each round sharded over the
    mesh). Asserts that

    - the sharded run's genotypes equal the serial per-event run's,
      apart from the engine marker (both with the float64 host engine);
    - ``merged_edge_counts`` over the mesh counts every read;
    - the float32 device engine's run, over the mesh, has every
      confident, PASS genotype of the serial run.

    `mesh` defaults to `n_devices` distinct cards, which must exist.
    Returns the events, samples and confident calls checked."""
    import torch

    from .genotyping.sample_info import load_manifest
    from .parallel.distributed import make_event_mesh
    from .parallel.mesh import merged_edge_counts
    from .pipeline.grmpy import GrmpyParameters, run_grmpy
    from .pipeline.multigrmpy import (MultigrmpyOptions,
                                      load_graph_description)

    if mesh is None:
        mesh = make_event_mesh("cuda", n_devices)
        if len(mesh) < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have "
                               f"{len(mesh)}")
    device = mesh[0]
    n_events = max(8, 2 * n_devices)
    reference = os.path.join(workload_dir, "ref.fa")
    manifest_path = os.path.join(workload_dir, "samples.txt")
    with tempfile.TemporaryDirectory() as out:
        descs = load_graph_description(MultigrmpyOptions(
            input=os.path.join(workload_dir, "candidates.vcf"),
            reference=reference, output=out, split_type="superloci"))
    if len(descs) < n_events:
        raise ValueError(f"{workload_dir} has {len(descs)} events, the dry "
                         f"run takes {n_events}")
    descs = descs[:n_events]

    def run(batch, engine):
        return run_grmpy(copy.deepcopy(descs), reference,
                         load_manifest(manifest_path), None,
                         GrmpyParameters(gt_engine=engine),
                         batch_events=batch, device=device, mesh=mesh)

    sharded = run(True, "host")
    serial = run(False, "host")
    if json.dumps(_strip_engine(sharded), sort_keys=True) != json.dumps(
            _strip_engine(serial), sort_keys=True):
        raise AssertionError("sharded != serial genotypes")

    # read-data-parallel count merge over the mesh
    n_reads = 4 * len(mesh)
    merged = merged_edge_counts(mesh, np.ones((n_reads, 4), np.int32))
    if merged.dtype != torch.int32 or merged.tolist() != [n_reads] * 4:
        raise AssertionError(f"merged edge counts {merged}, want "
                             f"{n_reads} per edge")

    # population-scale device genotyping over the mesh: every confident
    # genotype of the host engine's run
    on_device = run(True, "device")
    n_confident = 0
    for rec_h, rec_d in zip(serial, on_device):
        for name, sh in rec_h["samples"].items():
            gt_h = sh["gt"]
            gt_d = rec_d["samples"][name]["gt"]
            if gt_h.get("GQ", 0) >= 10 and "PASS" in gt_h.get("filters", []):
                if gt_d["GT"] != gt_h["GT"]:
                    raise AssertionError(f"device engine {name}: {gt_d}, "
                                         f"host {gt_h}")
                n_confident += 1
    return {"events": n_events,
            "samples": len(serial[0]["samples"]) if serial else 0,
            "confident_calls": n_confident}
