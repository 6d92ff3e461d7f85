"""Breakpoint discovery and per-breakpoint edge/allele count accumulation.

Equivalent of ``genotyping::BreakpointFinder`` and
``BreakpointStatistics`` (the reference's src/c++/lib/genotyping/
BreakpointFinder.cpp, BreakpointStatistics.cpp): a breakpoint is a node
with >1 successors ("node_") or >1 predecessors ("_node"); canonical
alleles are equivalence classes of edge-label sets with REF pinned first.
"""
from __future__ import annotations

from typing import Dict, List

from ..graph.model import SequenceGraph


class BreakpointStatistics:
    def __init__(self, graph: SequenceGraph, node_id: int, forward: bool):
        node_name = graph.node_name(node_id)
        allele_nodes = (graph.successors(node_id) if forward
                        else graph.predecessors(node_id))
        assert len(allele_nodes) > 1

        self.edge_names: List[str] = []
        self.edge_name_to_index: Dict[str, int] = {}
        self.all_allele_names: List[str] = []
        allele_edge_sets: Dict[str, set] = {}

        for an in allele_nodes:
            an_name = graph.node_name(an)
            edge_name = (f"{node_name}_{an_name}" if forward
                         else f"{an_name}_{node_name}")
            self.edge_names.append(edge_name)
            self.edge_name_to_index[edge_name] = len(self.edge_names) - 1
            labels = (graph.edge_labels(node_id, an) if forward
                      else graph.edge_labels(an, node_id))
            for allele_name in sorted(labels):
                allele_edge_sets.setdefault(allele_name, set()).add(edge_name)
                if allele_name not in self.all_allele_names:
                    self.all_allele_names.append(allele_name)

        # canonical alleles: group by identical edge sets; iteration in
        # canonical-id (sorted-string) order like the reference's std::map
        canonical_to_alleles: Dict[str, List[str]] = {}
        for allele in sorted(allele_edge_sets):  # std::map order
            canonical_id = ";".join(sorted(allele_edge_sets[allele]))
            canonical_to_alleles.setdefault(canonical_id, []).append(allele)

        self.canonical_allele_names: List[str] = []
        self.edgename_to_alleles: Dict[str, List[int]] = {}
        self.allele_name_to_index: Dict[str, int] = {}
        self.allele_name_to_canonical: Dict[str, str] = {}
        for canonical_id in sorted(canonical_to_alleles):  # std::map order
            members = canonical_to_alleles[canonical_id]
            canonical_name = members[0]
            if "REF" in members:
                canonical_name = "REF"
            self.canonical_allele_names.append(canonical_name)
            idx = len(self.canonical_allele_names) - 1
            for edge in sorted(allele_edge_sets[canonical_name]):
                self.edgename_to_alleles.setdefault(edge, []).append(idx)
            for allele in members:
                self.allele_name_to_index[allele] = idx
                self.allele_name_to_canonical[allele] = canonical_name

        self.edge_counts: List[int] = []
        self.allele_counts: List[int] = []

    def add_counts(self, paragraph_json: dict) -> None:
        """BreakpointStatistics::addCounts (BreakpointStatistics.cpp:112-150)."""
        if "read_counts_by_edge" not in paragraph_json:
            raise ValueError("Cannot find read_counts_by_edge in JSON")
        counts = paragraph_json["read_counts_by_edge"]
        for edge_name in self.edge_names:
            e_idx = self.edge_name_to_index[edge_name]
            this_count = int(counts.get(edge_name, 0))
            if this_count == 0:
                continue
            if len(self.edge_counts) <= e_idx:
                self.edge_counts += [0] * (
                    len(self.edge_names) - len(self.edge_counts))
            self.edge_counts[e_idx] += this_count
            for allele in self.edgename_to_alleles.get(edge_name, []):
                if len(self.allele_counts) <= allele:
                    self.allele_counts += [0] * (
                        len(self.canonical_allele_names)
                        - len(self.allele_counts))
                self.allele_counts[allele] += this_count

    def get_count(self, name: str) -> int:
        """BreakpointStatistics::getCount (BreakpointStatistics.cpp:152-176)."""
        in_edges = name in self.edge_name_to_index
        in_alleles = name in self.allele_name_to_index
        if in_edges and in_alleles:
            raise ValueError(f"Allele name {name} ambiguous with edge name")
        if in_edges:
            idx = self.edge_name_to_index[name]
            return self.edge_counts[idx] if idx < len(self.edge_counts) else 0
        if in_alleles:
            idx = self.allele_name_to_index[name]
            return (self.allele_counts[idx]
                    if idx < len(self.allele_counts) else 0)
        return 0

    def get_canonical_allele_name(self, allele: str) -> str:
        return self.allele_name_to_canonical.get(allele, allele)


def create_breakpoint_map(graph: SequenceGraph
                          ) -> Dict[str, BreakpointStatistics]:
    """createBreakpointMap (BreakpointFinder.cpp:50-77); keys iterate in
    std::map (sorted string) order."""
    breakpoint_map: Dict[str, BreakpointStatistics] = {}
    source_node = 0
    sink_node = graph.num_nodes - 1
    has_source_and_sink = (graph.node_name(source_node) == "source"
                           and graph.node_name(sink_node) == "sink")
    for node in range(graph.num_nodes):
        if has_source_and_sink and node in (source_node, sink_node):
            continue
        node_name = graph.node_name(node)
        if len(graph.successors(node)) > 1:
            breakpoint_map[node_name + "_"] = BreakpointStatistics(
                graph, node, True)
        if len(graph.predecessors(node)) > 1:
            breakpoint_map["_" + node_name] = BreakpointStatistics(
                graph, node, False)
    return dict(sorted(breakpoint_map.items()))
