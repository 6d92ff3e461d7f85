#!/usr/bin/env python3
"""cProfile of the port's host-side pipeline stages.

Counterpart of the repository's ``tools/prof_host.py``. Over the first N
events of a workload it profiles

  A. extraction      (BAM read retrieval and decode, reads/extraction.py)
  C. dispatch tables (build_pair_tables, the parent's host cost per
                      dispatch, three times over)
  B. analysis        (align_and_disambiguate and count_and_genotype with
                      precomputed scores: the work of a pipelined worker)

Scores come from the paired scorer on ``--device`` and are not profiled.
The workload is a directory of ``tests/tools/make_workload.py`` (the tool
does not make one: that generator imports the JAX package's BGZF
reader); by default ``$TMPDIR/prof_host_wl<events>_s<seed>``, where the
JAX package's tool generates its own when ``TMPDIR`` is ``/tmp``. Prints
each stage's top functions by cumulative time, then one JSON line:
``extract_ms_per_event``, ``tables_ms_per_event``,
``analysis_ms_per_event``.

    python -m paragraph_tpu_torch.tools.prof_host [--events 64]
        [--seed 11] [--workload DIR] [--device cuda]
    python3 paragraph_tpu_torch/tools/prof_host.py ...   (the same)
"""
import argparse
import copy
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    # run by path: import the package from the checkout this file is in
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "paragraph_tpu_torch.tools"


def report(name, pr, seconds, n):
    s = io.StringIO()
    stats = pstats.Stats(pr, stream=s)
    stats.sort_stats("cumulative").print_stats(18)
    print(f"\n===== {name}: {seconds:.2f}s total, "
          f"{seconds / n * 1e3:.1f} ms/event =====")
    for line in s.getvalue().splitlines()[4:40]:
        print(line)


def default_workload(events: int, seed: int) -> str:
    """$TMPDIR/prof_host_wl<events>_s<seed>."""
    return os.path.join(tempfile.gettempdir(),
                        f"prof_host_wl{events}_s{seed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_host")
    ap.add_argument("--events", type=int, default=64)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--workload", default=None,
                    help="make_workload directory (default: "
                         "$TMPDIR/prof_host_wl<events>_s<seed>)")
    ap.add_argument("--device", default="cuda",
                    help="device of the (unprofiled) scoring")
    args = ap.parse_args(argv)

    wl = args.workload or default_workload(args.events, args.seed)
    if not os.path.isfile(os.path.join(wl, "candidates.vcf")):
        raise SystemExit(
            f"no workload in {wl}: make one with python3 "
            f"tests/tools/make_workload.py {wl} --events {args.events} "
            f"--seed {args.seed}")

    from ..genotyping.sample_info import load_manifest
    from ..graph.model import SequenceGraph
    from ..io.cram import open_alignment_reader
    from ..ops.multi_sw import TILE_LANES, PairedGraphSW, build_pair_tables
    from ..pipeline.grmpy import (GrmpyParameters,
                                  _make_paragraph_parameters,
                                  count_and_genotype)
    from ..pipeline.multigrmpy import (MultigrmpyOptions,
                                       load_graph_description)
    from ..pipeline.paragraph import Parameters, align_and_disambiguate
    from ..reads.extraction import extract_reads
    from ..reads.read import UNMAPPED

    with tempfile.TemporaryDirectory() as out:
        opts = MultigrmpyOptions(
            input=os.path.join(wl, "candidates.vcf"),
            manifest=os.path.join(wl, "samples.txt"),
            reference=os.path.join(wl, "ref.fa"), output=out,
            split_type="superloci")
        t0 = time.perf_counter()
        graph_descs = load_graph_description(opts)[:args.events]
        print(f"convert_input: {time.perf_counter() - t0:.2f}s "
              f"for {len(graph_descs)} events")
    n = len(graph_descs)
    manifest = load_manifest(opts.manifest)
    ref = opts.reference
    params = GrmpyParameters()
    sample = manifest[0]
    reader = open_alignment_reader(sample.filename, sample.index_filename,
                                   ref)

    # ---- A: extraction ----
    pps = []
    for gd in graph_descs:
        pp = Parameters()
        pp.max_reads = params.max_reads
        pp.load(gd, ref)
        pps.append(pp)
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    reads_per_event = [extract_reads(reader, pp.target_regions,
                                     pp.max_reads, pp.longest_alt_insertion)
                       for pp in pps]
    pr.disable()
    te = time.perf_counter() - t0
    report("extraction", pr, te, n)

    # ---- scores on the device (not profiled) ----
    graphs = []
    pparams = []
    for gd in graph_descs:
        pp2 = _make_paragraph_parameters(params, gd, ref, False)
        pparams.append(pp2)
        graphs.append(SequenceGraph.from_json(pp2.description, ref))
    t0 = time.perf_counter()
    sw = PairedGraphSW(graphs, device=args.device)
    batches = [[r.bases.upper() for r in reads if r.bases]
               for reads in reads_per_event]
    scores = sw.score_pairs(batches)
    print(f"scoring ({args.device}): {time.perf_counter() - t0:.2f}s")

    # ---- C: dispatch tables (the parent's cost per dispatch) ----
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for _ in range(3):
        for c, idxs in enumerate(sw.chunk_pairs):
            build_pair_tables(sw.chunk_arrays[c],
                              [batches[p] for p in idxs], TILE_LANES)
    pr.disable()
    tc = time.perf_counter() - t0
    report("build_pair_tables x3", pr, tc, 3 * n)

    # ---- B: analysis with precomputed scores ----
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for gi, gd in enumerate(graph_descs):
        reads = reads_per_event[gi]
        for r in reads:
            if r.bases:
                r.graph_mapping_status = UNMAPPED
        f_out, r_out = scores[gi]
        sc = (f_out[0], f_out[4], r_out[4], f_out[1], f_out[2], f_out[3])
        output = align_and_disambiguate(
            pparams[gi], reads, graph=graphs[gi], precomputed_scores=sc)
        output["bam"] = sample.filename
        for key in ("alignments", "node_coverage", "path_coverage",
                    "phasing", "variants"):
            output.pop(key, None)
        s2 = copy.copy(sample)
        s2.alignment_data = output
        count_and_genotype(gd, ref, None, [s2])
    pr.disable()
    tb = time.perf_counter() - t0
    report("analysis", pr, tb, n)

    print(json.dumps({"extract_ms_per_event": te / n * 1e3,
                      "tables_ms_per_event": tc / 3 / n * 1e3,
                      "analysis_ms_per_event": tb / n * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
