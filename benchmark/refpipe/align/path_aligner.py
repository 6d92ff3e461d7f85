"""Exact-match aligner via unique graph kmers.

Equivalent of ``grm::PathAligner``
(the reference's src/c++/lib/grm/PathAligner.cpp): 32-mer graph index
lookup, unique hits extended by maximal unambiguous matching
(graph-tools extendPathMatching, PathOperations.cpp:117-271); only
full-read-length exact matches produce alignments (mapq 60 when unique).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..graph.model import SequenceGraph
from ..reads.read import Read, MAPPED
from .graph_aligner import reverse_complement
from .kmer_index import KmerIndex


@dataclass
class LitePath:
    node_ids: Tuple[int, ...]
    start: int  # offset of first base in first node
    end: int  # offset of last base in last node

    def length(self, graph: SequenceGraph) -> int:
        if len(self.node_ids) == 1:
            return self.end - self.start + 1
        total = len(graph.node_seq(self.node_ids[0])) - self.start
        for nid in self.node_ids[1:-1]:
            total += len(graph.node_seq(nid))
        total += self.end + 1
        return total

    def node_overlaps(self, graph: SequenceGraph) -> List[int]:
        if len(self.node_ids) == 1:
            return [self.end - self.start + 1]
        out = [len(graph.node_seq(self.node_ids[0])) - self.start]
        for nid in self.node_ids[1:-1]:
            out.append(len(graph.node_seq(nid)))
        out.append(self.end + 1)
        return out


def extend_path_end_matching(graph: SequenceGraph, path: LitePath,
                             query: str, qpos: int) -> LitePath:
    """PathOperations.cpp:117-189."""
    pos_in_query = qpos + path.length(graph)
    node = path.node_ids[-1]
    pos_in_node = path.end + 1
    nodes = list(path.node_ids)
    moved = True
    while moved:
        moved = False
        node_seq = graph.node_seq(node)
        while (pos_in_query < len(query) and pos_in_node < len(node_seq)
               and query[pos_in_query] == node_seq[pos_in_node]):
            moved = True
            pos_in_node += 1
            pos_in_query += 1
        if pos_in_node >= len(node_seq):
            successors = graph.successors(node)
            num_longest = 0
            longest = 0
            chosen = 0
            if successors:
                succ_min = min(
                    len(graph.node_seq(s)) for s in successors)
            else:
                succ_min = 0
            for succ in successors:
                succ_seq = graph.node_seq(succ)
                p = 0
                while (p < succ_min and pos_in_query + p < len(query)
                       and succ_seq[p] == query[pos_in_query + p]):
                    p += 1
                if p > longest:
                    longest = p
                    chosen = succ
                    num_longest = 1
                elif p == longest:
                    num_longest += 1
            if longest == 0 or num_longest != 1:
                break
            nodes.append(chosen)
            pos_in_query += longest
            pos_in_node = longest
            node = chosen
            moved = True
    return LitePath(tuple(nodes), path.start, pos_in_node - 1)


def extend_path_start_matching(graph: SequenceGraph, path: LitePath,
                               query: str, qpos: int
                               ) -> Tuple[LitePath, int]:
    """PathOperations.cpp:191-266; returns (path, updated qpos)."""
    node = path.node_ids[0]
    pos_in_node = path.start
    pos_in_query = qpos
    nodes = list(path.node_ids)
    moved = True
    while moved:
        moved = False
        node_seq = graph.node_seq(node)
        while (pos_in_query > 0 and pos_in_node > 0
               and query[pos_in_query - 1] == node_seq[pos_in_node - 1]):
            moved = True
            pos_in_node -= 1
            pos_in_query -= 1
        if pos_in_node == 0:
            predecessors = graph.predecessors(node)
            num_longest = 0
            longest = 0
            chosen = 0
            if predecessors:
                pred_min = min(
                    len(graph.node_seq(p)) for p in predecessors)
            else:
                pred_min = 0
            for pred in predecessors:
                pred_seq = graph.node_seq(pred)
                pos_in_pred = len(pred_seq)
                match_length = 0
                while (pos_in_pred > len(pred_seq) - pred_min
                       and pos_in_query - match_length > 0
                       and pred_seq[pos_in_pred - 1]
                       == query[pos_in_query - match_length - 1]):
                    pos_in_pred -= 1
                    match_length += 1
                if match_length > longest:
                    longest = match_length
                    chosen = pred
                    num_longest = 1
                elif match_length == longest:
                    num_longest += 1
            if longest == 0 or num_longest != 1:
                break
            nodes.insert(0, chosen)
            pos_in_query -= longest
            node = chosen
            pos_in_node = len(graph.node_seq(node)) - longest
            moved = True
    return LitePath(tuple(nodes), pos_in_node, path.end), pos_in_query


def extend_path_matching(graph: SequenceGraph, path: LitePath, query: str,
                         qpos: int) -> Tuple[LitePath, int]:
    extended = extend_path_end_matching(graph, path, query, qpos)
    return extend_path_start_matching(graph, extended, query, qpos)


class PathAligner:
    def __init__(self, kmer_size: int = 32):
        self.kmer_size = kmer_size
        self.index: Optional[KmerIndex] = None
        self.graph: Optional[SequenceGraph] = None
        self.attempted = 0
        self.anchored = 0
        self.mapped = 0

    def set_graph(self, graph: SequenceGraph, paths=None):
        self.graph = graph
        self.index = KmerIndex(graph, self.kmer_size)

    def align_read(self, read: Read) -> None:
        """PathAligner::alignRead (PathAligner.cpp:75-163)."""
        self.attempted += 1
        k = self.kmer_size
        g = self.graph
        read_length = len(read.bases)
        if read_length < k:
            return
        matches: List[Tuple[int, LitePath, bool]] = []
        for strand in range(2):
            is_reverse = strand != 0
            read_bases = (reverse_complement(read.bases) if is_reverse
                          else read.bases)
            pos = 0
            while pos + k <= len(read_bases):
                kmer = read_bases[pos:pos + k]
                if self.index.num_paths(kmer) == 1:
                    node_ids, start, end = self.index.get_paths(kmer)[0]
                    path = LitePath(tuple(node_ids), start, end)
                    extended, qpos = extend_path_matching(
                        g, path, read_bases, pos)
                    matches.append((qpos, extended, is_reverse))
                    pos = qpos + extended.length(g)
                pos += 1
        if matches:
            self.anchored += 1
        full = [m for m in matches if m[1].length(g) == read_length]
        if not full:
            return
        qpos, path, is_reverse = full[0]
        if is_reverse:
            read.bases = reverse_complement(read.bases)
            read.is_graph_reverse_strand = True
        else:
            read.is_graph_reverse_strand = False

        # qpos S / len M / rest S projected onto the path nodes
        overlaps = path.node_overlaps(g)
        cigar_parts = []
        for i, (nid, ov) in enumerate(zip(path.node_ids, overlaps)):
            ops = ""
            if i == 0 and qpos > 0:
                ops += f"{qpos}S"
            ops += f"{ov}M"
            if (i == len(overlaps) - 1
                    and qpos + path.length(g) < read_length):
                ops += f"{read_length - qpos - path.length(g)}S"
            cigar_parts.append(f"{nid}[{ops}]")
        read.graph_alignment_score = path.length(g)
        read.graph_cigar = "".join(cigar_parts)
        read.graph_pos = path.start
        read.graph_mapping_status = MAPPED
        if len(full) > 1:
            read.is_graph_alignment_unique = False
            read.graph_mapq = 0
        else:
            read.is_graph_alignment_unique = True
            read.graph_mapq = 60
        self.mapped += 1
