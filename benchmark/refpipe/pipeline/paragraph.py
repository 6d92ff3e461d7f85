"""Per-graph read alignment and disambiguation.

Counterpart of ``paragraph_tpu/pipeline/paragraph.py``
(paragraph::alignAndDisambiguate and paragraph::Parameters,
Disambiguation.cpp:152-361, Parameters.hh/.cpp), scoring through the
port's aligner on the caller's device. ``Parameters`` and the output
flags are copied unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..align.composite import align_reads
from ..graph.coordinates import GraphCoordinates
from ..graph.model import SequenceGraph, paths_from_json
from ..reads.counting import count_reads
from ..reads.disambig import disambiguate_reads
from ..reads.filters import create_read_filter
from ..reads.read import BAD_ALIGN, Read
from ..reads.stats import summarize_alignments
from ..utils.numerics import f32

# output_options (Parameters.hh:63-76)
ALIGNMENTS = 0x01
FILTERED_ALIGNMENTS = 0x02
VARIANTS = 0x04
NODE_READ_COUNTS = 0x08
EDGE_READ_COUNTS = 0x10
PATH_READ_COUNTS = 0x20
DETAILED_READ_COUNTS = 0x40
PATH_COVERAGE = 0x80
NODE_COVERAGE = 0x100
HAPLOTYPES = 0x200
ALL = 0xFFFFFFFF


class Parameters:
    """paragraph::Parameters (Parameters.hh:44-145)."""

    def __init__(self, max_reads: int = 10000, min_reads_for_variant: int = 1,
                 min_frac_for_variant: float = 0.0,
                 bad_align_frac: float = 0.8, output_options: int = ALL,
                 path_sequence_matching: bool = False,
                 graph_sequence_matching: bool = True,
                 klib_sequence_matching: bool = False,
                 kmer_sequence_matching: bool = False,
                 validate_alignments: bool = False):
        self.max_reads = max_reads
        self.min_reads_for_variant = min_reads_for_variant
        self.min_frac_for_variant = min_frac_for_variant
        self.bad_align_frac = f32(bad_align_frac)
        self.output_options = output_options
        self.path_sequence_matching = path_sequence_matching
        self.graph_sequence_matching = graph_sequence_matching
        self.klib_sequence_matching = klib_sequence_matching
        self.kmer_sequence_matching = kmer_sequence_matching
        self.validate_alignments = validate_alignments
        self.description: dict = {}
        self.reference_path = ""
        self.target_regions: List[str] = []
        self.longest_alt_insertion = 0
        # 0 = auto (hardware concurrency), like the reference CLIs'
        # std::thread::hardware_concurrency() default (paragraph.cpp:73)
        self.threads = 0
        self.kmer_len = 0
        self.remove_nonuniq_reads = True

    def output_enabled(self, option: int) -> bool:
        return (self.output_options & option) != 0

    def load(self, graph_desc: dict, reference_path: str,
             override_target_regions: str = ""):
        """Parameters::load (Parameters.cpp:39-88)."""
        self.reference_path = reference_path
        root = dict(graph_desc)
        if "graph" in root:
            root.update(root["graph"])
            del root["graph"]
        self.description = root
        if override_target_regions:
            self.target_regions = override_target_regions.split(",")
        else:
            if not isinstance(root.get("target_regions"), list):
                raise ValueError(
                    'Graph description is missing "target_regions" key.')
            self.target_regions = [str(r) for r in root["target_regions"]]
        if "max_reads" in root:
            self.max_reads = int(root["max_reads"])
        for node in self.description.get("nodes", []):
            if ("sequence" in node
                    and len(node["sequence"]) > self.longest_alt_insertion):
                self.longest_alt_insertion = len(node["sequence"])


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
        from .haplotypes import add_haplotype_paths

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
        from .variants import get_variants

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
