"""Canonical (linearized) graph coordinates and min-distance queries.

Equivalent of graph-tools' ``GraphCoordinates``
(graph-tools src/graphcore/GraphCoordinates.cpp): each base on the graph has
a canonical offset (nodes laid out in topological order); distance between
positions is the minimum base distance along edges, computed with the same
predecessor DP the reference uses.
"""
from __future__ import annotations

import bisect
from typing import Dict, Tuple

from .model import SequenceGraph

_UINT64_MAX = 2 ** 64 - 1


class GraphCoordinates:
    def __init__(self, graph: SequenceGraph):
        self.graph = graph
        self.canonical_offsets: Dict[str, int] = {}
        self._node_start_offsets = []
        self._node_start_names = []
        # (source_node_id, target_node_id) -> min bases between end of source
        # and start of target (excluding both), for non-adjacent pairs
        self.node_end_to_start: Dict[Tuple[int, int], int] = {}

        offset = 0
        n = graph.num_nodes
        for n_id in range(n):
            name = graph.node_name(n_id)
            self.canonical_offsets[name] = offset
            self._node_start_offsets.append(offset)
            self._node_start_names.append(name)
            offset += max(1, len(graph.node_seq(n_id)))

            # GraphCoordinates.cpp:50-77 — min distance via predecessors
            for n_source in range(n):
                if n_id == n_source or graph.has_edge(n_source, n_id):
                    continue
                min_dist = _UINT64_MAX
                for pred in graph.predecessors(n_id):
                    key = (n_source, pred)
                    if key in self.node_end_to_start:
                        min_dist = min(
                            min_dist,
                            self.node_end_to_start[key]
                            + len(graph.node_seq(pred)))
                    elif graph.has_edge(n_source, pred):
                        min_dist = min(min_dist, len(graph.node_seq(pred)))
                if min_dist != _UINT64_MAX:
                    self.node_end_to_start[(n_source, n_id)] = min_dist

    def canonical_pos(self, node_name: str, offset: int = 0) -> int:
        return self.canonical_offsets[node_name] + offset

    def node_and_offset(self, canonical_pos: int) -> Tuple[str, int]:
        i = bisect.bisect_right(self._node_start_offsets, canonical_pos) - 1
        if i < 0:
            i = 0
        return (self._node_start_names[i],
                canonical_pos - self._node_start_offsets[i])

    def canonical_start_and_end(self, node_ids, start_pos: int,
                                end_pos: int) -> Tuple[int, int]:
        """Start/end canonical positions of a path (GraphCoordinates.cpp:125).

        `start_pos` is the offset in the first node, `end_pos` the offset in
        the last node (path end position, graph-tools semantics).
        """
        first = self.canonical_pos(
            self.graph.node_name(node_ids[0]), start_pos)
        second = _UINT64_MAX
        if len(node_ids) > 0 and end_pos > 0:
            second = self.canonical_pos(
                self.graph.node_name(node_ids[-1]), end_pos)
        if first > second:
            first, second = second, first
        return first, second

    def distance(self, pos1: int, pos2: int) -> int:
        if pos1 == pos2:
            return 0
        if pos2 < pos1:
            pos1, pos2 = pos2, pos1
        n1, off1 = self.node_and_offset(pos1)
        n2, off2 = self.node_and_offset(pos2)
        if n1 == n2:
            return pos2 - pos1
        g = self.graph
        n1_id = g.name_to_id[n1]
        n2_id = g.name_to_id[n2]
        n1_len = len(g.node_seq(n1_id))
        if g.has_edge(n1_id, n2_id):
            return n1_len - off1 + off2
        key = (n1_id, n2_id)
        if key in self.node_end_to_start:
            return n1_len - off1 + off2 + self.node_end_to_start[key]
        return _UINT64_MAX
