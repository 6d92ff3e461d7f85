"""Multi-sample align + genotype workflow on one device.

Counterpart of ``align_single_sample``, ``align_samples_batched`` and
``run_grmpy`` in ``paragraph_tpu/pipeline/grmpy.py`` (grmpy::Workflow,
AlignSamples.cpp, CountAndGenotype.cpp). Scoring runs on the caller's
device through the port; a failure raises. Parameters, read extraction
and the float64 host genotyping are the JAX package's.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from typing import Dict, List, Optional

from paragraph_tpu.genotyping.sample_info import SampleInfo
from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.io.cram import open_alignment_reader as BamReader
from paragraph_tpu.pipeline.grmpy import (  # noqa: F401 (re-export)
    GrmpyParameters, _make_paragraph_parameters, _write_alignments_json,
    count_and_genotype, make_event_genotyper)
from paragraph_tpu.reads.extraction import extract_reads
from paragraph_tpu.reads.read import UNMAPPED

from .. import add_stats, resolve_device
from .paragraph import align_and_disambiguate

logger = logging.getLogger("grmpy")

_OUTPUT_ONLY_KEYS = ("alignments", "node_coverage", "path_coverage",
                     "phasing", "variants")


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
