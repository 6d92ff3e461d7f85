"""Graph kmer index: kmer → unique path lookup.

Equivalent of graph-tools' ``KmerIndex``
(graph-tools src/graphalign/KmerIndex.cpp): for every node and start
offset, enumerate all k-base walks (crossing edges at node boundaries) and
index them by sequence. Unique kmers (exactly one indexed walk) drive the
exact-match PathAligner and the KmerFilter uniqueness test.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..graph.model import SequenceGraph

# A path here is (node_ids tuple, start_offset, end_offset) with both
# offsets 0-based inclusive (graph-tools Path semantics).
KPath = Tuple[Tuple[int, ...], int, int]


class KmerIndex:
    def __init__(self, graph: SequenceGraph, kmer_len: int):
        self.graph = graph
        self.kmer_len = kmer_len
        self.kmer_to_paths: Dict[str, List[KPath]] = defaultdict(list)
        for node_id in range(graph.num_nodes):
            self._add_paths_starting_at_node(node_id)
        self.node_kmer_counts: Dict[int, int] = defaultdict(int)
        self.edge_kmer_counts: Dict[Tuple[int, int], int] = defaultdict(int)
        for kmer, paths in self.kmer_to_paths.items():
            if len(paths) == 1:
                node_ids = paths[0][0]
                prev = None
                for nid in node_ids:
                    self.node_kmer_counts[nid] += 1
                    if prev is not None:
                        self.edge_kmer_counts[(prev, nid)] += 1
                    prev = nid

    def _add_paths_starting_at_node(self, node_id: int):
        g = self.graph
        seq = g.node_seq(node_id)
        k = self.kmer_len
        for pos in range(len(seq)):
            # extend right to exactly k bases, branching at node ends
            stack = [((node_id,), pos, pos, seq[pos:pos + 1])]
            # take k-1 more bases
            need_total = k
            results = []
            while stack:
                node_ids, start, end, s = stack.pop()
                if len(s) == need_total:
                    results.append(((node_ids, start, end), s))
                    continue
                last = node_ids[-1]
                last_seq = g.node_seq(last)
                if end + 1 < len(last_seq):
                    take = min(need_total - len(s),
                               len(last_seq) - (end + 1))
                    stack.append((node_ids, start, end + take,
                                  s + last_seq[end + 1:end + 1 + take]))
                else:
                    for succ in g.successors(last):
                        succ_seq = g.node_seq(succ)
                        if not succ_seq:
                            continue
                        take = min(need_total - len(s), len(succ_seq))
                        stack.append((node_ids + (succ,), start, take - 1,
                                      s + succ_seq[:take]))
            for path, s in results:
                self.kmer_to_paths[s].append(path)

    def num_paths(self, kmer: str) -> int:
        return len(self.kmer_to_paths.get(kmer, ()))

    def get_paths(self, kmer: str) -> Optional[List[KPath]]:
        return self.kmer_to_paths.get(kmer)

    def num_unique_kmers_overlapping_node(self, node_id: int) -> int:
        return self.node_kmer_counts.get(node_id, 0)

    def num_unique_kmers_overlapping_edge(self, f: int, t: int) -> int:
        return self.edge_kmer_counts.get((f, t), 0)


def find_min_covering_kmer_length(graph: SequenceGraph,
                                  min_per_edge: int,
                                  min_per_node: int) -> int:
    """KmerIndexOperations.cpp:77-113."""
    for k in range(10, 64):
        index = KmerIndex(graph, k)
        any_below = False
        for node_id in range(graph.num_nodes):
            if index.num_unique_kmers_overlapping_node(node_id) < min_per_node:
                any_below = True
                break
            for succ in graph.successors(node_id):
                if index.num_unique_kmers_overlapping_edge(
                        node_id, succ) < min_per_edge:
                    any_below = True
                    break
            if any_below:
                break
        if not any_below:
            return k
    return 0
