"""Aligner cascade entry point: exact path match → graph SW.

Counterpart of ``align_reads`` / ``_align_reads_batched`` in
``paragraph_tpu/align/composite.py``. The batched graph stage scores on
the caller's device through the port's ``BatchedGraphAligner``; the
non-batched cascade (kmer / klib / validation) is the JAX package's own
``CompositeAligner``, which never touches a device.
"""
from __future__ import annotations

import logging
from typing import List, Optional

from paragraph_tpu.align.composite import CompositeAligner, ReadFilter
from paragraph_tpu.align.path_aligner import PathAligner
from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.reads.read import BAD_ALIGN, MAPPED, UNMAPPED, Read

log = logging.getLogger("paragraph")


def align_reads(graph: SequenceGraph, paths, reads: List[Read],
                filt: Optional[ReadFilter],
                path_matching: bool, graph_matching: bool,
                klib_matching: bool, kmer_matching: bool,
                validate_alignments: bool = False,
                threads: int = 1,
                engine: str = "batched",
                precomputed_scores=None,
                stats_out: Optional[dict] = None,
                trace_uniq_only: bool = False,
                device="cuda",
                kernel_stats: Optional[dict] = None) -> List[Read]:
    """grm::alignReads (Align.cpp:114-156): align every read and keep only
    those that end MAPPED. Returns the filtered read buffer.

    engine="batched" scores all reads in one single-graph fill per graph
    orientation on `device` and runs the exact traceback on the host;
    engine="scalar" runs the per-read scalar cascade. `precomputed_scores`
    injects (f_score, f_multi, r_multi[, f_end_node, f_end_ref,
    f_end_read]) from a cross-event scoring pass. `trace_uniq_only` skips
    traceback for non-unique reads. The scorers' stats are added into
    `kernel_stats` when given.
    """
    if engine == "batched" and graph_matching and not (
            validate_alignments or klib_matching or kmer_matching):
        return _align_reads_batched(graph, paths, reads, filt,
                                    path_matching, precomputed_scores,
                                    threads=threads, stats_out=stats_out,
                                    trace_uniq_only=trace_uniq_only,
                                    device=device,
                                    kernel_stats=kernel_stats)
    aligner = CompositeAligner(path_matching, graph_matching,
                               klib_matching, kmer_matching)
    if validate_alignments:
        from paragraph_tpu.align.validation import ValidationAligner

        aligner = ValidationAligner(aligner, graph, paths)
    aligner.set_graph(graph, paths)
    kept: List[Read] = []
    for read in reads:
        if not read.bases:
            continue
        read.graph_mapping_status = UNMAPPED
        aligner.align_read(read, filt)
        if read.graph_mapping_status == MAPPED:
            kept.append(read)
    if validate_alignments:
        for line in aligner.report():
            log.info(line)
    counters = aligner.aligner if validate_alignments else aligner
    log.info(
        "[Done with alignment step] %d total aligned "
        "(exact: %d / kmers: %d / sw: %d) ; %d were filtered",
        len(kept), counters.mapped_path, counters.mapped_kmers,
        counters.mapped_sw, counters.filtered)
    return kept


def _align_reads_batched(graph: SequenceGraph, paths, reads: List[Read],
                         filt: Optional[ReadFilter],
                         path_matching: bool,
                         precomputed_scores=None,
                         threads: int = 1,
                         stats_out: Optional[dict] = None,
                         trace_uniq_only: bool = False,
                         device="cuda",
                         kernel_stats: Optional[dict] = None) -> List[Read]:
    from .. import add_stats
    from .batched_aligner import BatchedGraphAligner

    path_aligner = None
    if path_matching:
        path_aligner = PathAligner()
        path_aligner.set_graph(graph)

    needs_graph: List[Read] = []
    for read in reads:
        if not read.bases:
            continue
        read.graph_mapping_status = UNMAPPED
        if path_aligner is not None:
            path_aligner.align_read(read)
        if read.graph_mapping_status == MAPPED and filt and filt(read):
            read.graph_mapping_status = BAD_ALIGN
        if read.graph_mapping_status != MAPPED:
            needs_graph.append(read)

    batched = BatchedGraphAligner(graph,
                                  scoring=precomputed_scores is None,
                                  threads=threads, device=device)
    # only reads still unmapped go to the graph stage (BAD_ALIGN reads get
    # the same second chance the CompositeAligner gives them)
    stage2 = [r for r in needs_graph if r.graph_mapping_status != MAPPED]
    batched.align_reads_batch(stage2, precomputed=precomputed_scores,
                              trace_uniq_only=trace_uniq_only)
    if stats_out is not None:
        stats_out["engine"] = batched.engine
    for scorer in batched.scorers():
        add_stats(kernel_stats, scorer.stats)
    n_filtered = 0
    for read in stage2:
        read.graph_mapping_status = MAPPED
        if filt and filt(read):
            read.graph_mapping_status = BAD_ALIGN
            n_filtered += 1

    kept = [r for r in reads
            if r.bases and r.graph_mapping_status == MAPPED]
    n_sw = sum(1 for r in stage2 if r.graph_mapping_status == MAPPED)
    log.info(
        "[Done with alignment step] %d total aligned "
        "(exact: %d / kmers: 0 / sw: %d) ; %d were filtered",
        len(kept), len(kept) - n_sw, n_sw, n_filtered)
    return kept
