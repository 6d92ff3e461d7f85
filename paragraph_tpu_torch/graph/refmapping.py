"""Graph→reference coordinate projection.

Equivalent of graph-tools' GraphReferenceMapping
(graph-tools src/graphcore/GraphReferenceMapping.cpp; API in
include/graphcore/GraphReferenceMapping.hh:40-105): register reference
paths through the graph (each anchored to a contig + start), then
project single (node, offset) positions or whole paths back onto
reference coordinates. Path decomposition reuses intersect_paths
(pipeline/haplotypes.py), the same PathOperations primitive the C++
implementation calls.
"""
from __future__ import annotations

from typing import List, NamedTuple, Set, Tuple

from ..pipeline.haplotypes import LitePath, intersect_paths
from .model import SequenceGraph


class ReferencePosition(NamedTuple):
    contig: str
    pos: int


class ReferenceInterval(NamedTuple):
    contig: str
    start: int
    end: int


class GraphReferenceMapping:
    """Maps graph positions to reference positions via registered
    reference paths (GraphReferenceMapping.hh:40-60)."""

    def __init__(self, graph: SequenceGraph):
        self.graph = graph
        self._mappings: List[Tuple[LitePath, ReferencePosition]] = []

    def add_mapping(self, path: LitePath, contig: str, start: int) -> None:
        """addMapping (GraphReferenceMapping.cpp:58-61)."""
        self._mappings.append((path, ReferencePosition(contig, start)))

    def map_position(self, node: int, offset: int) -> Set[ReferencePosition]:
        """All reference positions a (node, offset) maps to
        (GraphReferenceMapping.cpp:63-93). The in-bounds test keeps the
        reference's `or` between the lower and upper bound checks."""
        result: Set[ReferencePosition] = set()
        for path, anchor in self._mappings:
            if node not in path.nodes:
                continue
            pos_in_path = 0
            for n, current in enumerate(path.nodes):
                pos_in_node = path.start if n == 0 else 0
                if n == len(path.nodes) - 1:
                    node_span_end = path.end + 1
                else:
                    node_span_end = len(self.graph.node_seq(current))
                if current == node:
                    if offset >= pos_in_node or offset < node_span_end:
                        result.add(ReferencePosition(
                            anchor.contig,
                            pos_in_path + offset - pos_in_node + anchor.pos))
                    break
                pos_in_path += node_span_end - pos_in_node
        return result

    def _distance_from_path_start(self, path: LitePath, node: int,
                                  offset: int) -> int:
        """Path::getDistanceFromPathStart: graph distance from the
        path's first position to (node, offset) along the path."""
        dist = 0
        for n, current in enumerate(path.nodes):
            start = path.start if n == 0 else 0
            if current == node:
                return dist + offset - start
            dist += len(self.graph.node_seq(current)) - start
        raise ValueError(f"node {node} not on path")

    def map_path(self, path: LitePath
                 ) -> Set[Tuple[str, ReferenceInterval]]:
        """Decompose `path` into reference sub-paths with their matched
        reference intervals (GraphReferenceMapping.cpp:95-112). Each
        element pairs the sub-path's encoding (graph-tools Path::encode
        string — hashable stand-in for the C++ Path set key) with its
        interval."""
        result: Set[Tuple[str, ReferenceInterval]] = set()
        for ref_path, anchor in self._mappings:
            for piece in intersect_paths(self.graph, ref_path, path):
                path_offset = self._distance_from_path_start(
                    ref_path, piece.nodes[0], piece.start)
                start = anchor.pos + path_offset
                end = start + piece.length(self.graph) - 1
                result.add((piece.encode(self.graph),
                            ReferenceInterval(anchor.contig, start, end)))
        return result
