"""Multi-sample align + genotype workflow on one device.

Counterpart of ``align_single_sample``, ``align_samples_batched`` and
``run_grmpy`` in ``paragraph_tpu/pipeline/grmpy.py`` (grmpy::Workflow,
AlignSamples.cpp, CountAndGenotype.cpp). Scoring runs on the caller's
device through the port; a failure raises. ``GrmpyParameters``, the
alignment dump and the float64 host genotyping are copied unchanged.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from typing import Dict, List, Optional

from .. import add_stats, resolve_device
from ..genotyping.graph_genotyper import GraphBreakpointGenotyper
from ..genotyping.sample_info import SampleInfo
from ..graph.model import SequenceGraph
from ..io.cram import open_alignment_reader as BamReader
from ..reads.extraction import extract_reads
from ..reads.read import UNMAPPED
from .paragraph import (ALL, DETAILED_READ_COUNTS, EDGE_READ_COUNTS,
                        HAPLOTYPES, NODE_READ_COUNTS, PATH_READ_COUNTS,
                        Parameters, align_and_disambiguate)

logger = logging.getLogger("grmpy")

_OUTPUT_ONLY_KEYS = ("alignments", "node_coverage", "path_coverage",
                     "phasing", "variants")


class GrmpyParameters:
    """grmpy::Parameters (grmpy/Parameters.hh)."""

    def __init__(self, threads: int = 0, max_reads: int = 10000,
                 bad_align_frac: float = 0.8,
                 path_sequence_matching: bool = False,
                 graph_sequence_matching: bool = True,
                 klib_sequence_matching: bool = False,
                 kmer_sequence_matching: bool = False,
                 bad_align_uniq_kmer_len: int = 0,
                 alignment_output_folder: str = "",
                 infer_read_haplotypes: bool = False,
                 progress: bool = False,
                 gt_engine: str = "auto"):
        self.threads = threads
        self.max_reads = max_reads
        self.bad_align_frac = bad_align_frac
        self.path_sequence_matching = path_sequence_matching
        self.graph_sequence_matching = graph_sequence_matching
        self.klib_sequence_matching = klib_sequence_matching
        self.kmer_sequence_matching = kmer_sequence_matching
        self.bad_align_uniq_kmer_len = bad_align_uniq_kmer_len
        self.alignment_output_folder = alignment_output_folder
        self.infer_read_haplotypes = infer_read_haplotypes
        self.progress = progress
        #: "host" = float64 parity engines per event;
        #: "device" = the device population engine, not ported: a run
        #: that resolves to it raises NotImplementedError
        self.gt_engine = gt_engine


def _write_alignments_json(output, parameters, paragraph_parameters,
                           reference_path, sample):
    """grmpy::writeAlignments (AlignSamples.cpp:57-109)."""
    import gzip
    import json
    import re

    out = dict(output)
    out["sample"] = sample.sample_name
    out["reference"] = reference_path
    unsafe = re.compile(r"[^A-Za-z0-9.-]")
    safe_sample = unsafe.sub("_", sample.sample_name)
    safe_regions = unsafe.sub(
        "_", "_".join(str(r) for r in paragraph_parameters.target_regions))
    graph = paragraph_parameters.description
    graph_id = graph.get("ID") or graph.get("model_name") or "graph"
    safe_graph_id = unsafe.sub("_", str(graph_id))
    path = os.path.join(
        parameters.alignment_output_folder,
        f"{safe_sample}-{safe_graph_id}-{safe_regions}.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(out, f, sort_keys=True, indent=4, separators=(",", ": "))


def make_event_genotyper(graph_desc: dict, reference_path: str,
                         genotyping_parameters: Optional[dict],
                         samples: List[SampleInfo],
                         graph: Optional[SequenceGraph] = None
                         ) -> GraphBreakpointGenotyper:
    """Breakpoint genotyper for one event with all sample alignments
    added (the counting half of grmpy::countAndGenotype). Callers that
    already built the event's SequenceGraph (the per-event analysis
    does, for alignment) pass it to skip a second from_json build."""
    root = graph_desc if graph_desc is not None else (
        samples[0].alignment_data)
    if graph is None:
        graph = SequenceGraph.from_json(root, reference_path)

    male_ploidy = 2
    female_ploidy = 2
    for t_region in root.get("target_regions", []):
        chrom = str(t_region).split(":")[0]
        if chrom in ("chrX", "X"):
            male_ploidy = 1
        elif chrom in ("chrY", "Y"):
            male_ploidy = 1
            female_ploidy = 1

    genotyper = GraphBreakpointGenotyper(graph, male_ploidy, female_ploidy)
    genotyper.set_parameters(genotyping_parameters)
    for sample_info in samples:
        genotyper.add_alignment(sample_info)
    return genotyper


def count_and_genotype(graph_desc: dict, reference_path: str,
                       genotyping_parameters: Optional[dict],
                       samples: List[SampleInfo],
                       graph: Optional[SequenceGraph] = None) -> dict:
    """grmpy::countAndGenotype (CountAndGenotype.cpp:46-88)."""
    return make_event_genotyper(graph_desc, reference_path,
                                genotyping_parameters,
                                samples, graph=graph).get_genotypes()


def _make_paragraph_parameters(parameters: GrmpyParameters,
                               graph_desc: dict, reference_path: str,
                               write_alignments: bool) -> Parameters:
    if write_alignments:
        output_options = ALL
    else:
        output_options = (NODE_READ_COUNTS | EDGE_READ_COUNTS
                          | PATH_READ_COUNTS | DETAILED_READ_COUNTS)
    if parameters.infer_read_haplotypes:
        output_options |= HAPLOTYPES
    else:
        output_options &= ~HAPLOTYPES
    pp = Parameters(
        parameters.max_reads,
        3 if write_alignments else parameters.max_reads + 1,
        0.01, parameters.bad_align_frac, output_options,
        parameters.path_sequence_matching,
        parameters.graph_sequence_matching,
        parameters.klib_sequence_matching,
        parameters.kmer_sequence_matching, False)
    pp.threads = parameters.threads
    pp.kmer_len = parameters.bad_align_uniq_kmer_len
    pp.load(graph_desc, reference_path)
    return pp


def resolve_gt_engine(parameters: GrmpyParameters, n_samples: int,
                      n_events: int) -> str:
    """gt_engine with "auto" resolved by the JAX package's rule (device
    for >= 4 samples and >= 8 events). The port genotypes on the host
    only: a run that resolves to "device" raises."""
    engine = parameters.gt_engine
    if engine == "auto":
        engine = "device" if n_samples >= 4 and n_events >= 8 else "host"
    if engine == "device":
        raise NotImplementedError(
            "the float32 device genotyping engine is not ported yet "
            "(ROADMAP queue A item 6); run with gt_engine='host'")
    return engine


def align_single_sample(parameters: GrmpyParameters, graph_desc: dict,
                        reference_path: str, reader: BamReader,
                        sample: SampleInfo, device="cuda",
                        kernel_stats: Optional[dict] = None) -> None:
    """grmpy::alignSingleSample (AlignSamples.cpp:115-172). The scorers'
    stats are added into `kernel_stats` when given."""
    write_alignments = (
        parameters.alignment_output_folder
        and os.path.isdir(parameters.alignment_output_folder))
    paragraph_parameters = _make_paragraph_parameters(
        parameters, graph_desc, reference_path, write_alignments)
    all_reads = extract_reads(
        reader, paragraph_parameters.target_regions, parameters.max_reads,
        paragraph_parameters.longest_alt_insertion)
    output = align_and_disambiguate(paragraph_parameters, all_reads,
                                    device=device, kernel_stats=kernel_stats)
    output["bam"] = sample.filename

    if write_alignments:
        _write_alignments_json(output, parameters, paragraph_parameters,
                               reference_path, sample)

    for key in _OUTPUT_ONLY_KEYS:
        output.pop(key, None)
    sample.alignment_data = output


def align_samples_batched(parameters: GrmpyParameters,
                          graph_descs: List[dict], reference_path: str,
                          manifest: List[SampleInfo],
                          readers: Dict[str, BamReader], device="cuda",
                          kernel_stats: Optional[dict] = None):
    """Cross-event batched alignment: extract reads for every (graph x
    sample) pair, score all pairs' orientations in one paired scorer
    (ops/multi_sw.py) on `device`, then finish each pair's host analysis
    with the injected scores. Output-identical to the sequential path.
    The scorer's stats are added into `kernel_stats` when given."""
    from ..ops.multi_sw import PairedGraphSW

    jobs = []  # (graph_desc, pp, graph, sample, reads)
    for graph_desc in graph_descs:
        graph = None
        pp_proto = None
        for sample in manifest:
            s = copy.copy(sample)
            if s.alignment_data is not None:
                jobs.append((graph_desc, None, None, s, None))
                continue
            if graph is None:
                pp_proto = _make_paragraph_parameters(
                    parameters, graph_desc, reference_path, False)
                graph = SequenceGraph.from_json(
                    pp_proto.description, reference_path)
            reader = readers.get(s.filename)
            if reader is None:
                reader = BamReader(s.filename, s.index_filename,
                                   reference_path)
                readers[s.filename] = reader
            reads = extract_reads(
                reader, pp_proto.target_regions, parameters.max_reads,
                pp_proto.longest_alt_insertion)
            jobs.append((graph_desc, pp_proto, graph, s, reads))

    scoring_jobs = [j for j in jobs if j[4] is not None]
    precomputed = {}
    if scoring_jobs:
        graphs = []
        batches = []
        for gd, pp, graph, s, reads in scoring_jobs:
            live = [r for r in reads if r.bases]
            for r in live:
                r.graph_mapping_status = UNMAPPED
            graphs.append(graph)
            batches.append([r.bases.upper() for r in live])
        paired = PairedGraphSW(graphs, device=device)
        results = paired.score_pairs(batches)
        add_stats(kernel_stats, paired.stats)
        for k, (f_out, r_out) in enumerate(results):
            precomputed[k] = (f_out[0], f_out[4], r_out[4],
                              f_out[1], f_out[2], f_out[3])

    for k, (gd, pp, graph, s, reads) in enumerate(scoring_jobs):
        output = align_and_disambiguate(
            pp, reads, graph=graph, precomputed_scores=precomputed[k],
            device=device)
        output["bam"] = s.filename
        for key in _OUTPUT_ONLY_KEYS:
            output.pop(key, None)
        s.alignment_data = output
    return jobs


def run_grmpy(graph_descs: List[dict], reference_path: str,
              manifest: List[SampleInfo],
              genotyping_parameters: Optional[dict] = None,
              parameters: Optional[GrmpyParameters] = None,
              batch_events: Optional[bool] = None, device="cuda",
              kernel_stats: Optional[dict] = None) -> List[dict]:
    """grmpy::Workflow::run (Workflow.cpp:191-239): align every
    (sample x graph), then genotype every graph; returns the list of
    genotyping result dicts (the genotypes.json array).

    batch_events=True scores all (graph x sample) pairs in one paired
    scorer (auto: multi-event runs without alignment dumps or
    non-default aligners). With >= 8 events and threads != 1 the
    pipelined orchestrator runs (pipeline/parallel_grmpy.py). Otherwise
    each (event x sample) scores its own reads through two single-graph
    scorers. Every scorer's stats are added into `kernel_stats` when
    given.
    """
    device = resolve_device(device)
    if parameters is None:
        parameters = GrmpyParameters()
    resolve_gt_engine(parameters, len(manifest), len(graph_descs))

    if batch_events is None:
        batch_events = (
            len(graph_descs) > 1
            and not parameters.alignment_output_folder
            and not parameters.path_sequence_matching
            and not parameters.klib_sequence_matching
            and not parameters.kmer_sequence_matching
            and parameters.graph_sequence_matching)

    if (batch_events and len(graph_descs) >= 8 and parameters.threads != 1
            and not parameters.alignment_output_folder):
        from .parallel_grmpy import run_grmpy_pipelined

        return run_grmpy_pipelined(graph_descs, reference_path, manifest,
                                   genotyping_parameters, parameters,
                                   device=device, kernel_stats=kernel_stats)

    # grmpy --progress (Workflow.cpp:114-120,173-179): periodic
    # "N/M events done" lines, throttled to one every 10s plus a final one.
    progress_state = {"last": time.monotonic()}
    total_events = len(graph_descs)

    def report_progress(done: int) -> None:
        if not parameters.progress:
            return
        now = time.monotonic()
        if done == total_events or now - progress_state["last"] >= 10.0:
            progress_state["last"] = now
            logger.info("[progress] %d/%d events done", done, total_events)

    readers: Dict[str, BamReader] = {}
    results = []
    if batch_events:
        jobs = align_samples_batched(parameters, graph_descs,
                                     reference_path, manifest, readers,
                                     device=device,
                                     kernel_stats=kernel_stats)
        by_graph: Dict[int, List[SampleInfo]] = {}
        order = []
        for gd, pp, graph, s, reads in jobs:
            key = id(gd)
            if key not in by_graph:
                by_graph[key] = []
                order.append((key, gd))
            by_graph[key].append(s)
        for key, gd in order:
            results.append(count_and_genotype(
                gd, reference_path, genotyping_parameters, by_graph[key]))
            report_progress(len(results))
        return results

    for graph_desc in graph_descs:
        graph_samples = []
        for sample in manifest:
            s = copy.copy(sample)
            if s.alignment_data is None:
                reader = readers.get(s.filename)
                if reader is None:
                    reader = BamReader(s.filename, s.index_filename,
                                       reference_path)
                    readers[s.filename] = reader
                align_single_sample(parameters, graph_desc, reference_path,
                                    reader, s, device=device,
                                    kernel_stats=kernel_stats)
            graph_samples.append(s)
        results.append(count_and_genotype(
            graph_desc, reference_path, genotyping_parameters,
            graph_samples))
        report_progress(len(results))
    return results
