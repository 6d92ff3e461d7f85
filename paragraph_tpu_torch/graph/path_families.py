"""Path-family operations: segments, maximal paths, family conversion.

Equivalent of graph-tools' PathFamilyOperations
(graph-tools src/graphcore/PathFamilyOperations.cpp, 210 LoC): derive
the maximal paths a family's edge set supports, turn graph labels and
paths into families. Families are plain edge sets over a SequenceGraph
(a lighter structure than reads/disambig.py's label-bound PathFamily);
paths use the LitePath model shared with pipeline/haplotypes.py's
PathOperations port.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple

from ..pipeline.haplotypes import (LitePath, check_paths_adjacent,
                                   check_prefix_suffix_overlap,
                                   merge_paths)
from .model import SequenceGraph

Edge = Tuple[int, int]


def _key(p: LitePath) -> Tuple[int, Tuple[int, ...], int]:
    """Path ordering (Path.cpp:492-505): start, node list, end."""
    return (p.start, tuple(p.nodes), p.end)


def family_contains_path(edges: Set[Edge], path: LitePath) -> bool:
    """PathFamily::containsPath semantics over a bare edge set: at least
    one path edge in the family, and no path edge that merely touches
    family nodes without being a family edge."""
    out_nodes = {f for f, _ in edges}
    in_nodes = {t for _, t in edges}
    matched = 0
    for a, b in zip(path.nodes, path.nodes[1:]):
        if (a, b) in edges:
            matched += 1
        elif a in out_nodes or b in in_nodes:
            return False
    return matched > 0


def get_path_segments_for_family(graph: SequenceGraph,
                                 edges: Iterable[Edge]) -> List[LitePath]:
    """getPathSegmentsForFamily (PathFamilyOperations.cpp:47-92):
    concatenate family edges into path segments, extending a segment
    through a node only when that node has in- and out-degree one
    within the family subgraph. Self-loop edges are skipped."""
    sorted_edges = sorted(edges)
    in_count: Dict[int, int] = {}
    out_count: Dict[int, int] = {}
    for f, t in sorted_edges:
        out_count[f] = out_count.get(f, 0) + 1
        in_count[t] = in_count.get(t, 0) + 1

    segments: List[LitePath] = []
    for f, t in sorted_edges:
        if f == t:
            continue
        extended = False
        for prefix in segments:
            if (prefix.nodes[-1] == f and in_count.get(f) == 1
                    and out_count.get(f) == 1):
                prefix.nodes.append(t)
                prefix.end = len(graph.node_seq(t)) - 1
                extended = True
        if not extended:
            segments.append(LitePath(
                [f, t], 0, len(graph.node_seq(t)) - 1))
    return segments


def enumerate_path_combinations_in_family(
        graph: SequenceGraph, edges: Set[Edge],
        segments: List[LitePath], max_paths: int = 128
) -> Tuple[List[LitePath], bool]:
    """enumeratePathCombinationsInFamily (PathFamilyOperations.cpp:
    94-173): repeatedly merge overlapping/adjacent segments across the
    family's edges until a fixed point; returns (paths, complete) with
    complete=False when max_paths was exceeded. Iteration order mirrors
    the C++ std::set-of-Path ordering so outputs compare directly."""
    starting: Dict[int, Dict[Tuple, LitePath]] = {}
    ending: Dict[int, Dict[Tuple, LitePath]] = {}

    def insert(p: LitePath) -> None:
        starting.setdefault(p.nodes[0], {})[_key(p)] = p
        ending.setdefault(p.nodes[-1], {})[_key(p)] = p

    def remove(p: LitePath) -> None:
        starting.get(p.nodes[0], {}).pop(_key(p), None)
        ending.get(p.nodes[-1], {}).pop(_key(p), None)

    for seg in segments:
        insert(seg)

    complete = True
    any_merged = True
    while any_merged:
        any_merged = False
        merged: Dict[Tuple, LitePath] = {}
        for edge in sorted(edges):
            for pre_node, suf_node in ((edge[0], edge[0]),
                                       (edge[1], edge[1]),
                                       (edge[0], edge[1])):
                prefixes = sorted(ending.get(pre_node, {}).values(),
                                  key=_key)
                suffixes = sorted(starting.get(suf_node, {}).values(),
                                  key=_key)
                for prefix in prefixes:
                    for suffix in suffixes:
                        if (check_prefix_suffix_overlap(prefix, suffix)
                                or check_paths_adjacent(graph, prefix,
                                                        suffix)):
                            seg = merge_paths(prefix, suffix)
                            insert(seg)
                            merged[_key(prefix)] = prefix
                            merged[_key(suffix)] = suffix
                            any_merged = True
        for p in merged.values():
            remove(p)
        count = sum(len(d) for d in starting.values())
        if count > max_paths:
            complete = False
            break

    paths: List[LitePath] = []
    for node in sorted(starting):
        for key in sorted(starting[node]):
            paths.append(starting[node][key])
            if len(paths) > max_paths:
                return paths, False
    return paths, complete


def get_maximal_paths_for_family(graph: SequenceGraph, edges: Set[Edge],
                                 max_paths: int = 128
                                 ) -> Tuple[List[LitePath], bool]:
    """getMaximalPathsForFamily (PathFamilyOperations.cpp:175-179)."""
    segments = get_path_segments_for_family(graph, edges)
    return enumerate_path_combinations_in_family(
        graph, set(edges), segments, max_paths)


def get_path_families_from_graph(graph: SequenceGraph
                                 ) -> Dict[str, Set[Edge]]:
    """getPathFamiliesFromGraph (PathFamilyOperations.cpp:181-191):
    one family (edge set) per edge label in the graph."""
    families: Dict[str, Set[Edge]] = {}
    for f, t in graph.edges():
        for label in graph.edge_labels(f, t):
            families.setdefault(label, set()).add((f, t))
    return families


def path_to_path_family(path: LitePath) -> Set[Edge]:
    """pathToPathFamily (PathFamilyOperations.cpp:193-203)."""
    return set(zip(path.nodes, path.nodes[1:]))
