"""Graph aligner: strand selection, uniqueness, CIGAR production.

Equivalent of grm::GraphAligner (GraphAligner.cpp:259-405): aligns the read
and its reverse complement against the forward graph, and the reversed read
(both strands) against the reversed graph; an alignment is *unique* when
neither orientation's top score ends at more than one node; the returned
strand prefers uniqueness, then score, defaulting to forward
(GraphAligner.cpp:340-356). MAPQ is 60 for unique alignments else 0.
"""
from __future__ import annotations

from typing import Optional

from ..graph.model import SequenceGraph
from ..reads.read import Read, MAPPED
from .gssw import GraphSW

_COMPLEMENT = str.maketrans("ACGTNacgtnXx", "TGCANtgcanXx")

AF_CIGAR = 0x01
AF_BOTH_STRANDS = 0x02
AF_REVERSE_GRAPH = 0x04
AF_ALL = 0xFFFFFFFF


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


class GraphAligner:
    def __init__(self, graph: Optional[SequenceGraph] = None):
        self._fwd: Optional[GraphSW] = None
        self._rev: Optional[GraphSW] = None
        if graph is not None:
            self.set_graph(graph)

    def set_graph(self, graph: SequenceGraph):
        self._fwd = GraphSW(graph)
        self._rev = GraphSW(graph.reversed())

    def align_read(self, read: Read, flags: int = AF_ALL) -> None:
        fwd_bases = read.bases.upper()
        rev_cmp = reverse_complement(read.bases).upper()

        gm_fwd, fwd_multi = self._fwd.align(fwd_bases)
        gm_rev, rev_multi = (None, False)
        if flags & AF_BOTH_STRANDS:
            gm_rev, rev_multi = self._fwd.align(rev_cmp)

        rfwd_multi = rrev_multi = False
        if flags & AF_REVERSE_GRAPH:
            bases_rev = fwd_bases[::-1]
            _, rfwd_multi = self._rev.align(bases_rev)
            if flags & AF_BOTH_STRANDS:
                _, rrev_multi = self._rev.align(
                    reverse_complement(bases_rev))

        fwd_unique = (not fwd_multi) and (not rfwd_multi)
        rev_unique = (not rev_multi) and (not rrev_multi)

        return_reverse = False
        if (not fwd_unique) and rev_unique and gm_rev is not None:
            return_reverse = True
        elif fwd_unique and not rev_unique:
            return_reverse = False
        elif gm_rev is not None:
            return_reverse = gm_fwd.score < gm_rev.score

        read.is_graph_reverse_strand = (
            read.is_reverse_strand != return_reverse)

        if return_reverse:
            read.bases = rev_cmp
            read.quals = read.quals[::-1]
            gm = gm_rev
            unique = rev_unique
        else:
            gm = gm_fwd
            unique = fwd_unique

        read.graph_pos = gm.position
        read.graph_alignment_score = gm.score
        read.is_graph_alignment_unique = unique
        read.graph_mapq = 60 if unique else 0
        if flags & AF_CIGAR:
            read.graph_cigar = gm.cigar_string()
