"""Read filter chain: NonUniq, BadAlign, KmerFilter.

Equivalent of the reference's chain-of-responsibility read filters
(the reference's src/c++/lib/paragraph/ReadFilter.cpp and readfilters/):
first failing filter wins and labels the read.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..align.alignment import decode_graph_alignment, decode_read_alignment
from ..graph.model import SequenceGraph
from ..utils.numerics import c_round
from .read import Read


class NonUniqFilter:
    """readfilters/NonUniq.hh: drop reads without a unique best alignment."""

    def filter_read(self, read: Read) -> Tuple[bool, str]:
        bad = not read.is_graph_alignment_unique
        return bad, "nonuniq" if bad else ""


class BadAlignFilter:
    """readfilters/BadAlign.hh: require >= bad_align_frac of the query to be
    aligned (non-clipped)."""

    def __init__(self, graph: SequenceGraph, bad_align_frac: float):
        self.graph = graph
        self.bad_align_frac = bad_align_frac

    def filter_read(self, read: Read) -> Tuple[bool, str]:
        mapping = decode_read_alignment(read)
        query_clipped = sum(a.num_clipped for a in mapping.alignments)
        query_aligned = mapping.query_length - query_clipped
        is_bad = query_aligned < c_round(
            self.bad_align_frac * mapping.query_length)
        return is_bad, "bad_align" if is_bad else ""


class KmerFilter:
    """readfilters/KmerFilter.cpp: require every node touched by the
    alignment that has unique covering kmers to be covered by a unique kmer
    from the (unclipped part of the) read."""

    def __init__(self, graph: SequenceGraph, kmer_len: int):
        from ..align.kmer_index import KmerIndex, find_min_covering_kmer_length

        if kmer_len < 0:
            kmer_len = find_min_covering_kmer_length(
                graph, -kmer_len, -kmer_len)
        self.graph = graph
        self.kmer_len = kmer_len
        self.index = KmerIndex(graph, kmer_len)

    def filter_read(self, read: Read) -> Tuple[bool, str]:
        alignment = decode_read_alignment(read)
        if len(alignment) < 1:
            return True, "kmer_nomapping"
        sc_left = alignment.alignments[0].num_clipped
        sc_right = alignment.alignments[-1].num_clipped
        bases = read.bases
        if len(bases) - sc_left - sc_right < self.kmer_len:
            return True, "kmer_tooshort"
        kmers = set()
        for pos in range(sc_left,
                         len(bases) - sc_right - self.kmer_len + 1):
            kmers.add(bases[pos:pos + self.kmer_len])
        nodes_not_covered = set()
        nodes_supported = []
        for node_id in alignment.node_ids:
            if self.index.num_unique_kmers_overlapping_node(node_id) > 0:
                nodes_not_covered.add(node_id)
                nodes_supported.append(node_id)
        for kmer in kmers:
            paths = self.index.get_paths(kmer)
            if paths is not None and len(paths) == 1:
                for node_id in paths[0][0]:
                    nodes_not_covered.discard(node_id)
                    if not nodes_not_covered:
                        return False, ""
        msg = "kmer_uncov"
        for node in nodes_supported:
            if node in nodes_not_covered:
                msg += "_" + str(node)
        return True, msg


class ReadFilterChain:
    def __init__(self, filters: List[object]):
        self.filters = filters

    def filter_read(self, read: Read) -> Tuple[bool, str]:
        for f in self.filters:
            result = f.filter_read(read)
            if result[0]:
                return result
        return False, ""


def create_read_filter(graph: SequenceGraph, remove_nonuniq: bool,
                       bad_align_frac: float,
                       kmer_len: int) -> ReadFilterChain:
    """ReadFilter.cpp:73-90."""
    filters: List[object] = []
    if remove_nonuniq:
        filters.append(NonUniqFilter())
    filters.append(BadAlignFilter(graph, bad_align_frac))
    if kmer_len != 0:
        filters.append(KmerFilter(graph, kmer_len))
    return ReadFilterChain(filters)
