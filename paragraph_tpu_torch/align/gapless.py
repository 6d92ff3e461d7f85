"""Gapless graph alignment (kmer-seeded, no indels).

Equivalent of graph-tools' GaplessAligner
(graph-tools src/graphalign/GaplessAligner.cpp, 153 LoC, plus the
KmerIndexOperations helpers): seed on the query's first unique kmer,
extend the seed path to full query length in every possible way, align
without gaps against each candidate and keep the match-count maxima.
Base comparison is degenerate-aware (graphutils/BaseMatching.hh): a
query base matches a reference symbol when it is in the symbol's IUPAC
expansion, case-insensitively.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..graph.expand import SYMBOL_EXPANSION
from ..graph.model import SequenceGraph
from .alignment import GraphAlignment, NodeAlignment
from .gapped import Path, extend_path_end, extend_path_start, path_length
from .kmer_index import KmerIndex

Ops = List[Tuple[int, str]]


def extract_kmers_from_all_positions(sequence: str,
                                     kmer_len: int) -> List[str]:
    """extractKmersFromAllPositions (KmerIndexOperations.cpp:38-46)."""
    return [sequence[pos:pos + kmer_len]
            for pos in range(len(sequence) - kmer_len + 1)]


def count_kmer_matches(index: KmerIndex, seq: str) -> int:
    """countKmerMatches (KmerIndexOperations.cpp:48-62)."""
    return sum(1 for kmer in extract_kmers_from_all_positions(
        seq, index.kmer_len) if index.num_paths(kmer) != 0)


def check_if_forward_oriented(index: KmerIndex, sequence: str) -> bool:
    """checkIfForwardOriented (KmerIndexOperations.cpp:64-69)."""
    from .graph_aligner import reverse_complement

    return (count_kmer_matches(index, sequence)
            >= count_kmer_matches(index, reverse_complement(sequence)))


def bases_match(query_base: str, ref_base: str) -> bool:
    """kBaseMatchLookupTable semantics (BaseMatching.hh:36-46)."""
    return query_base.upper() in SYMBOL_EXPANSION.get(ref_base.upper(), "")


def align_without_gaps(ref_start: int, reference: str,
                       query: str) -> NodeAlignment:
    """alignWithoutGaps over two linear sequences
    (GaplessAligner.cpp:106-152): M/X runs at a fixed offset."""
    if len(reference) < ref_start + len(query):
        raise ValueError(
            f"Gapless alignment requires that sequences {query} and "
            f"{reference} have same length.")
    if not query or not reference:
        raise ValueError("Cannot align empty sequences")
    ops: Ops = []
    run_len = 0
    run_op = ""
    for index, q in enumerate(query):
        cur = "M" if bases_match(q, reference[ref_start + index]) else "X"
        if cur == run_op:
            run_len += 1
        else:
            if run_op:
                ops.append((run_len, run_op))
            run_len = 1
            run_op = cur
    ops.append((run_len, run_op))
    return NodeAlignment(ref_start, ops)


def split_sequence_by_path(graph: SequenceGraph, path: Path,
                           seq: str) -> List[str]:
    """splitSequenceByPath (PathOperations.cpp): one query piece per
    path node, sized by the node's overlap with the path."""
    if path_length(graph, path) != len(seq):
        raise ValueError("path and sequence have different lengths")
    nodes, start, end = path
    pieces = []
    pos = 0
    for i, nid in enumerate(nodes):
        lo = start if i == 0 else 0
        hi = end if i == len(nodes) - 1 else len(graph.node_seq(nid)) - 1
        n = hi - lo + 1
        pieces.append(seq[pos:pos + n])
        pos += n
    return pieces


def align_path_without_gaps(graph: SequenceGraph, path: Path,
                            query: str) -> GraphAlignment:
    """alignWithoutGaps over a path (GaplessAligner.cpp:87-104)."""
    nodes, start, end = path
    pieces = split_sequence_by_path(graph, path, query)
    alignments = []
    for i, nid in enumerate(nodes):
        ref_start = start if i == 0 else 0
        alignments.append(align_without_gaps(
            ref_start, graph.node_seq(nid), pieces[i]))
    return GraphAlignment(list(nodes), alignments, start, end)


def get_best_alignment_to_short_path(graph: SequenceGraph, path: Path,
                                     start_pos: int, query: str
                                     ) -> List[GraphAlignment]:
    """getBestAlignmentToShortPath (GaplessAligner.cpp:62-85): extend
    the seed to full query span every possible way, keep the alignments
    with the maximal match count."""
    start_ext = start_pos
    end_ext = len(query) - start_pos - path_length(graph, path)
    full_paths: List[Path] = []
    for left in extend_path_start(graph, path, start_ext):
        full_paths.extend(extend_path_end(graph, left, end_ext))
    best: List[GraphAlignment] = []
    max_matches = -1
    for full in full_paths:
        ga = align_path_without_gaps(graph, full, query)
        n = sum(a.num_matched for a in ga.alignments)
        if n > max_matches:
            max_matches = n
            best = [ga]
        elif n == max_matches:
            best.append(ga)
    return best


class GaplessAligner:
    """GaplessAligner (GaplessAligner.cpp:43-60)."""

    def __init__(self, graph: SequenceGraph, kmer_len: int):
        self.graph = graph
        self.kmer_len = kmer_len
        self.index = KmerIndex(graph, kmer_len)

    def align(self, query: str) -> List[GraphAlignment]:
        for pos, kmer in enumerate(extract_kmers_from_all_positions(
                query, self.kmer_len)):
            if self.index.num_paths(kmer) == 1:
                kmer_path = self.index.get_paths(kmer)[0]
                return get_best_alignment_to_short_path(
                    self.graph, kmer_path, pos, query)
        return []
