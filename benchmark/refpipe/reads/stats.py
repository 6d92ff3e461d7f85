"""Alignment summary statistics per node / edge / allele.

Equivalent of paragraph's ``AlignmentStatistics`` and
``summarizeAlignments`` (the reference's src/c++/lib/paragraph/
AlignmentStatistics.cpp and GraphSummaryStatistics.cpp).
"""
from __future__ import annotations

from typing import Dict, List

from ..align.alignment import decode_read_alignment
from ..graph.model import SequenceGraph
from .read import Read, MAPPED


class AlignmentStatistics:
    def __init__(self, length: int):
        self.length = length
        self.num_match_bases = 0
        self.num_mismatch_bases = 0
        self.num_gap_bases = 0
        self.num_clip_bases = 0
        self.num_fwd_strand_reads = 0
        self.num_rev_strand_reads = 0

    def num_reads(self) -> int:
        return self.num_fwd_strand_reads + self.num_rev_strand_reads

    def _add_alignment_bases(self, aln, count_clipped: bool):
        self.num_match_bases += aln.num_matched
        self.num_mismatch_bases += aln.num_mismatched
        self.num_gap_bases += aln.num_inserted + aln.num_deleted
        if count_clipped:
            self.num_clip_bases += aln.num_clipped

    def add_node_mapping(self, aln, is_reverse: bool, count_clipped: bool):
        self._add_alignment_bases(aln, count_clipped)
        if is_reverse:
            self.num_rev_strand_reads += 1
        else:
            self.num_fwd_strand_reads += 1

    def add_edge_mapping(self, from_aln, to_aln, is_reverse: bool,
                         count_clipped_from: bool, count_clipped_to: bool):
        self._add_alignment_bases(from_aln, count_clipped_from)
        self._add_alignment_bases(to_aln, count_clipped_to)
        if is_reverse:
            self.num_rev_strand_reads += 1
        else:
            self.num_fwd_strand_reads += 1

    def add_allele_mapping(self, graph_alignment, is_reverse: bool,
                           has_source_and_sink: bool, num_nodes: int):
        source = 0
        sink = num_nodes - 1
        for idx, aln in enumerate(graph_alignment.alignments):
            node_id = graph_alignment.node_ids[idx]
            count_clipped = not (
                has_source_and_sink and (node_id in (source, sink)))
            self._add_alignment_bases(aln, count_clipped)
        if is_reverse:
            self.num_rev_strand_reads += 1
        else:
            self.num_fwd_strand_reads += 1

    def to_json(self) -> dict:
        denom = (self.num_match_bases + self.num_mismatch_bases
                 + self.num_gap_bases)
        out = {
            "num_fwd_reads": self.num_fwd_strand_reads,
            "num_rev_reads": self.num_rev_strand_reads,
            "mismatch_rate": (self.num_mismatch_bases / denom) if denom
            else float("nan"),
            "gap_rate": (self.num_gap_bases / denom) if denom
            else float("nan"),
            "clip_rate": (self.num_clip_bases / denom) if denom
            else float("nan"),
        }
        if self.length > 0:
            out["match_base_depth"] = self.num_match_bases / self.length
        out["contig_length"] = int(self.length)
        return out


def summarize_alignments(graph: SequenceGraph, reads: List[Read],
                         output: dict) -> None:
    """summarizeAlignments (GraphSummaryStatistics.cpp:47-184)."""
    gstats: Dict[str, Dict[str, AlignmentStatistics]] = {
        "nodes": {}, "edges": {}, "alleles": {}}
    allele_score_sum: Dict[str, int] = {}
    broken_path: Dict[str, int] = {}
    allele_lengths: Dict[str, int] = {}

    for n_id in range(graph.num_nodes):
        pred_labels = set()
        for pred in graph.predecessors(n_id):
            pred_labels |= graph.edge_labels(pred, n_id)
        succ_labels = set()
        for succ in graph.successors(n_id):
            succ_labels |= graph.edge_labels(n_id, succ)
        for s in sorted(pred_labels & succ_labels):
            allele_lengths[s] = (allele_lengths.get(s, 0)
                                 + len(graph.node_seq(n_id)))

    has_source_or_sink = (
        graph.node_name(0) == "source"
        or graph.node_name(graph.num_nodes - 1) == "sink")

    for read in reads:
        if read.graph_mapping_status != MAPPED:
            continue
        ga = decode_read_alignment(read)
        pred_node_id = None
        for idx, aln in enumerate(ga.alignments):
            current_node_id = ga.node_ids[idx]
            is_source_or_sink = has_source_or_sink and (
                current_node_id == 0
                or current_node_id == graph.num_nodes - 1)
            node_name = graph.node_name(current_node_id)
            if node_name not in gstats["nodes"]:
                gstats["nodes"][node_name] = AlignmentStatistics(
                    len(graph.node_seq(current_node_id)))
            gstats["nodes"][node_name].add_node_mapping(
                aln, read.is_graph_reverse_strand, not is_source_or_sink)
            if idx > 0:
                edge_name = graph.node_name(pred_node_id) + "_" + node_name
                if edge_name not in gstats["edges"]:
                    edge_length = (len(graph.node_seq(pred_node_id))
                                   + len(graph.node_seq(current_node_id)))
                    gstats["edges"][edge_name] = AlignmentStatistics(
                        edge_length)
                # NB the reference passes (current_node_id - 1 == 0) for the
                # "from" clip flag (GraphSummaryStatistics.cpp:135), i.e.
                # counts from-clips when the predecessor is node 1
                gstats["edges"][edge_name].add_edge_mapping(
                    ga.alignments[idx - 1], aln,
                    read.is_graph_reverse_strand,
                    has_source_or_sink and (current_node_id - 1 == 0),
                    is_source_or_sink)
            pred_node_id = current_node_id

        for allele in read.graph_sequences_supported:
            if allele not in gstats["alleles"]:
                gstats["alleles"][allele] = AlignmentStatistics(
                    allele_lengths.get(allele, 0))
            allele_score_sum.setdefault(allele, 0)
            gstats["alleles"][allele].add_allele_mapping(
                ga, read.is_graph_reverse_strand, has_source_or_sink,
                graph.num_nodes)
            allele_score_sum[allele] += read.graph_alignment_score
        for allele in read.graph_sequences_broken:
            broken_path[allele] = broken_path.get(allele, 0) + 1

    out_stats: dict = {}
    for gkey in ("nodes", "edges", "alleles"):
        out_stats[gkey] = {}
        for name in sorted(gstats[gkey]):
            st = gstats[gkey][name]
            j = st.to_json()
            if gkey == "alleles":
                j["avr_score"] = (
                    0 if st.num_reads() == 0
                    else allele_score_sum[name] / st.num_reads())
                if name in broken_path:
                    j["num_reads_for_broken_path"] = broken_path[name]
            out_stats[gkey][name] = j
    output["alignment_statistics"] = out_stats
