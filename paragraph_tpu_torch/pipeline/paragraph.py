"""Per-graph read alignment and disambiguation.

Counterpart of ``align_and_disambiguate`` in
``paragraph_tpu/pipeline/paragraph.py`` (paragraph::alignAndDisambiguate,
Disambiguation.cpp:152-361), scoring through the port's aligner on the
caller's device. ``Parameters`` and the output flags are the JAX
package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from paragraph_tpu.graph.coordinates import GraphCoordinates
from paragraph_tpu.graph.model import SequenceGraph, paths_from_json
from paragraph_tpu.pipeline.paragraph import (  # noqa: F401 (re-export)
    ALIGNMENTS, ALL, DETAILED_READ_COUNTS, EDGE_READ_COUNTS,
    FILTERED_ALIGNMENTS, HAPLOTYPES, NODE_COVERAGE, NODE_READ_COUNTS,
    PATH_COVERAGE, PATH_READ_COUNTS, VARIANTS, Parameters)
from paragraph_tpu.reads.counting import count_reads
from paragraph_tpu.reads.disambig import disambiguate_reads
from paragraph_tpu.reads.filters import create_read_filter
from paragraph_tpu.reads.read import BAD_ALIGN, Read
from paragraph_tpu.reads.stats import summarize_alignments

from ..align.composite import align_reads


def align_and_disambiguate(parameters: Parameters,
                           all_reads: List[Read],
                           graph: Optional[SequenceGraph] = None,
                           precomputed_scores=None,
                           device="cuda",
                           kernel_stats: Optional[dict] = None) -> dict:
    """Mutates `all_reads` to the filtered/kept set and returns the output
    JSON dict. `graph`/`precomputed_scores` let the cross-event
    orchestrators reuse construction and device scores; without scores
    the reads are scored on `device`, and the scorers' stats are added
    into `kernel_stats` when given."""
    if graph is None:
        graph = SequenceGraph.from_json(
            parameters.description, parameters.reference_path)
    output = dict(parameters.description)
    output["reference"] = parameters.reference_path

    output_reads: List[Read] = []
    if (parameters.output_enabled(ALIGNMENTS)
            or parameters.output_enabled(FILTERED_ALIGNMENTS)):
        output["alignments"] = []

    read_filter = create_read_filter(
        graph, parameters.remove_nonuniq_reads, parameters.bad_align_frac,
        parameters.kmer_len)
    total_reads_input = len(all_reads)
    read_filter_counts: Dict[str, int] = {}

    def read_filter_function(r: Read) -> bool:
        filtered, error = read_filter.filter_read(r)
        if filtered and parameters.output_enabled(FILTERED_ALIGNMENTS):
            r.graph_mapping_status = BAD_ALIGN
            r_json = r.to_json()
            r_json["error"] = error
            read_filter_counts[error] = read_filter_counts.get(error, 0) + 1
            output["alignments"].append(r_json)
            output_reads.append(r)
        return filtered

    align_stats: Dict[str, object] = {}
    # non-unique reads need no CIGAR when the NonUniq filter (first in
    # the chain) drops them and no alignment record is ever emitted
    trace_uniq_only = (
        parameters.remove_nonuniq_reads
        and not parameters.output_enabled(ALIGNMENTS)
        and not parameters.output_enabled(FILTERED_ALIGNMENTS))
    kept = align_reads(
        graph, paths_from_json(graph, parameters.description.get("paths")),
        all_reads, read_filter_function,
        parameters.path_sequence_matching,
        parameters.graph_sequence_matching,
        parameters.klib_sequence_matching,
        parameters.kmer_sequence_matching,
        parameters.validate_alignments, parameters.threads,
        precomputed_scores=precomputed_scores, stats_out=align_stats,
        trace_uniq_only=trace_uniq_only, device=device,
        kernel_stats=kernel_stats)
    all_reads[:] = kept

    if parameters.output_enabled(HAPLOTYPES):
        from paragraph_tpu.pipeline.haplotypes import add_haplotype_paths

        add_haplotype_paths(all_reads, graph,
                            parameters.description.get("paths", []), output)
        for json_edge in output.get("edges", []):
            f = graph.name_to_id[json_edge["from"]]
            t = graph.name_to_id[json_edge["to"]]
            json_edge["sequences"] = sorted(graph.edge_labels(f, t))

    disambiguate_reads(graph, all_reads)

    coordinates = GraphCoordinates(graph)
    count_reads(
        coordinates, all_reads, output,
        parameters.output_enabled(NODE_READ_COUNTS),
        parameters.output_enabled(EDGE_READ_COUNTS),
        parameters.output_enabled(PATH_READ_COUNTS),
        parameters.output_enabled(DETAILED_READ_COUNTS))

    if parameters.output_enabled(VARIANTS) or parameters.output_enabled(
            NODE_COVERAGE) or parameters.output_enabled(PATH_COVERAGE):
        from paragraph_tpu.pipeline.variants import get_variants

        get_variants(
            coordinates, all_reads, output,
            parameters.min_reads_for_variant,
            parameters.min_frac_for_variant,
            parameters.description.get("paths", []),
            parameters.output_enabled(VARIANTS),
            parameters.output_enabled(NODE_COVERAGE),
            parameters.output_enabled(PATH_COVERAGE))

    summarize_alignments(graph, all_reads, output)
    bad_alignment_pct = 0.0
    if total_reads_input > 0:
        bad_alignment_pct = (
            read_filter_counts.get("bad_align", 0) / total_reads_input)
    output["alignment_statistics"]["bad_alignment_pct"] = bad_alignment_pct
    if align_stats.get("engine"):
        # which scoring engine ran (cuda | torch | precomputed)
        output["alignment_statistics"]["engine"] = align_stats["engine"]
    for error, count in sorted(read_filter_counts.items()):
        output["alignment_statistics"]["read_filter_" + error] = count

    if parameters.output_enabled(ALIGNMENTS):
        for r in all_reads:
            output["alignments"].append(r.to_json())
            output_reads.append(r)
    all_reads[:] = output_reads

    return output
