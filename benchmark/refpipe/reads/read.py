"""Read model: BAM fields + graph alignment annotations.

Equivalent of the reference's ``common::Read``
(the reference's src/c++/include/common/Read.hh): raw read data plus the
graph-mapping fields the pipeline fills in (position, node-CIGAR, mapq,
mapping status, supported nodes/edges/path families).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

UNMAPPED = "UNMAPPED"
MAPPED = "MAPPED"
BAD_ALIGN = "BAD_ALIGN"


@dataclass
class Read:
    fragment_id: str = ""
    bases: str = ""
    quals: str = ""

    # BAM mate/coordinate info
    is_mapped: bool = False
    is_first_mate: bool = False
    is_mate_mapped: bool = False
    is_reverse_strand: bool = False
    is_mate_reverse_strand: bool = False
    chrom_id: int = -1
    pos: int = -1
    mapq: int = 0
    mate_chrom_id: int = -1
    mate_pos: int = -1

    # graph alignment results
    graph_pos: int = -1
    graph_cigar: str = ""
    graph_mapq: int = 0
    graph_alignment_score: int = -1
    is_graph_alignment_unique: bool = False
    is_graph_reverse_strand: bool = False
    graph_mapping_status: str = UNMAPPED

    graph_nodes_supported: List[str] = field(default_factory=list)
    graph_edges_supported: List[str] = field(default_factory=list)
    graph_sequences_supported: List[str] = field(default_factory=list)
    graph_sequences_broken: List[str] = field(default_factory=list)

    @classmethod
    def from_bam_record(cls, rec) -> "Read":
        """Mirror decodeHtsAlign (BamReader.cpp:84-107)."""
        return cls(
            fragment_id=rec.fragment_id,
            bases=rec.bases,
            quals=rec.quals,
            is_mapped=rec.is_mapped,
            is_first_mate=rec.is_first_mate,
            is_mate_mapped=rec.is_mate_mapped,
            is_reverse_strand=rec.is_reverse_strand,
            is_mate_reverse_strand=rec.is_mate_reverse_strand,
            chrom_id=rec.chrom_id,
            pos=rec.pos,
            mapq=rec.mapq,
            mate_chrom_id=rec.mate_chrom_id,
            mate_pos=rec.mate_pos,
        )

    def to_json(self) -> dict:
        """Subset of common::Read JSON serialization (Read.hh toJson)."""
        out = {
            "fragmentId": self.fragment_id,
            "bases": self.bases,
            "quals": self.quals,
            "chromId": self.chrom_id,
            "pos": self.pos,
            "MAPQ": self.mapq,
            "mateChromId": self.mate_chrom_id,
            "matePos": self.mate_pos,
            "isFirstMate": self.is_first_mate,
            "isMapped": self.is_mapped,
            "isMateMapped": self.is_mate_mapped,
            "isReverseStrand": self.is_reverse_strand,
            "isMateReverseStrand": self.is_mate_reverse_strand,
            "graphPos": self.graph_pos,
            "graphCigar": self.graph_cigar,
            "graphMapq": self.graph_mapq,
            "graphAlignmentScore": self.graph_alignment_score,
            "isGraphAlignmentUnique": self.is_graph_alignment_unique,
            "isGraphReverseStrand": self.is_graph_reverse_strand,
            "graphMappingStatus": self.graph_mapping_status,
            "graphNodesSupported": list(self.graph_nodes_supported),
            "graphEdgesSupported": list(self.graph_edges_supported),
            "graphSequencesSupported": list(self.graph_sequences_supported),
        }
        return out
