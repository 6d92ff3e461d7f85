"""Read disambiguation: node / edge / path-family support annotation.

Equivalent of paragraph's ``disambiguateReads`` + the node/edge filters in
``alignAndDisambiguate`` (the reference's src/c++/lib/paragraph/
Disambiguation.cpp:82-142 and :212-296): decides which graph elements each
mapped read supports and which haplotype path families contain its path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..align.alignment import GraphAlignment, decode_read_alignment
from ..graph.model import SequenceGraph
from .read import Read, MAPPED


class PathFamily:
    """Edge set carrying one haplotype label
    (graph-tools PathFamily.cpp:58-108)."""

    def __init__(self, graph: SequenceGraph, label: str):
        self.edges: Set[Tuple[int, int]] = set()
        self.in_nodes: Set[int] = set()
        self.out_nodes: Set[int] = set()
        for (f, t) in graph.edges():
            if label in graph.edge_labels(f, t):
                self.edges.add((f, t))
                self.out_nodes.add(f)
                self.in_nodes.add(t)

    def contains_path(self, node_ids: List[int]) -> bool:
        matched = 0
        for a, b in zip(node_ids, node_ids[1:]):
            if (a, b) in self.edges:
                matched += 1
            elif a in self.out_nodes or b in self.in_nodes:
                return False
        return matched > 0


def node_filter(graph: SequenceGraph, read: Read, node_name: str,
                alignment: GraphAlignment,
                name_to_id: Dict[str, int]) -> bool:
    """Disambiguation.cpp:212-242: a read supports a node when its per-node
    alignment has <= len(read)/2 non-matching bases, and exactly matches on
    nodes shorter than half the read."""
    node_id = name_to_id[node_name]
    is_short_node = len(graph.node_seq(node_id)) < len(read.bases) // 2
    for index, node_alignment in enumerate(alignment.alignments):
        if node_id == alignment.node_ids[index]:
            nonmatch = (node_alignment.num_mismatched
                        + node_alignment.num_clipped)
            indel = (node_alignment.num_inserted
                     + node_alignment.num_deleted)
            if is_short_node and (nonmatch > 0 or indel > 0):
                return False
            return nonmatch + indel <= len(read.bases) // 2
    return False


def edge_filter(graph: SequenceGraph, read: Read, node1: str, node2: str,
                alignment: GraphAlignment,
                name_to_id: Dict[str, int]) -> bool:
    """Disambiguation.cpp:244-296: both flanks of the edge must anchor with
    >= min(node_len, len/10+1) matched bases; soft-clips must stay under
    half the node span; plus a minimum overlap on at least one side."""
    node_id1 = name_to_id[node1]
    node_id2 = name_to_id[node2]
    prev_alignment = None
    prev_node_id = None
    for index, node_alignment in enumerate(alignment.alignments):
        nid = alignment.node_ids[index]
        if (prev_alignment is not None and prev_node_id == node_id1
                and nid == node_id2):
            min_node_overlap = len(read.bases) // 10 + 1
            status = (
                prev_alignment.num_matched
                >= min(prev_alignment.reference_length, min_node_overlap)
                and node_alignment.num_matched
                >= min(node_alignment.reference_length, min_node_overlap))
            if status:
                status = (
                    prev_alignment.query_length
                    < prev_alignment.reference_length * 2
                    and node_alignment.query_length
                    < node_alignment.reference_length * 2)
            if status:
                node1_length = len(graph.node_seq(node_id1))
                node2_length = len(graph.node_seq(node_id2))
                status = (
                    prev_alignment.num_matched
                    >= min(node1_length, min_node_overlap)
                    and node_alignment.num_matched
                    >= min(node2_length, min_node_overlap))
            return status
        prev_alignment = node_alignment
        prev_node_id = nid
    return False


def disambiguate_reads(graph: SequenceGraph, reads: List[Read],
                       use_node_filter: bool = True,
                       use_edge_filter: bool = True) -> None:
    """disambiguateReads (Disambiguation.cpp:82-142).

    Hot path: a path's node ids and its per-node alignments are
    index-aligned (DAG paths never repeat a node), so the filters run
    inline on alignment entry i instead of re-scanning the alignment
    per node/edge the way the standalone node_filter/edge_filter
    helpers (kept for API parity) do."""
    pfam_cache: Dict[str, PathFamily] = {}
    node_names = [graph.node_name(i) for i in range(graph.num_nodes)]
    node_lens = [len(graph.node_seq(i)) for i in range(graph.num_nodes)]
    for read in reads:
        read.graph_sequences_supported = []
        read.graph_nodes_supported = []
        read.graph_edges_supported = []
        if read.graph_mapping_status != MAPPED:
            continue
        gm = decode_read_alignment(read)
        path = gm.node_ids
        alns = gm.alignments
        half = len(read.bases) // 2
        min_ov = len(read.bases) // 10 + 1
        edges_supported: Set[Tuple[str, str]] = set()
        nodes_supported: Set[int] = set()
        overlapped_pfams: Set[str] = set()
        for i, node in enumerate(path):
            a = alns[i]
            if i:
                pnode = path[i - 1]
                if use_edge_filter:
                    pa = alns[i - 1]
                    ok = (pa.num_matched
                          >= min(pa.reference_length, min_ov)
                          and a.num_matched
                          >= min(a.reference_length, min_ov))
                    if ok:
                        ok = (pa.query_length < pa.reference_length * 2
                              and a.query_length < a.reference_length * 2)
                    if ok:
                        ok = (pa.num_matched
                              >= min(node_lens[pnode], min_ov)
                              and a.num_matched
                              >= min(node_lens[node], min_ov))
                else:
                    ok = True
                if ok:
                    edges_supported.add(
                        (node_names[pnode], node_names[node]))
                    overlapped_pfams.update(graph.edge_labels(pnode, node))
            if use_node_filter:
                nonmatch = a.num_mismatched + a.num_clipped
                indel = a.num_inserted + a.num_deleted
                if node_lens[node] < half:
                    ok = nonmatch == 0 and indel == 0
                else:
                    ok = nonmatch + indel <= half
            else:
                ok = True
            if ok:
                nodes_supported.add(node)

        for n in sorted(nodes_supported):
            read.graph_nodes_supported.append(node_names[n])
        for e in sorted(edges_supported):
            read.graph_edges_supported.append(e[0] + "_" + e[1])
        for label in sorted(overlapped_pfams):
            pfam = pfam_cache.get(label)
            if pfam is None:
                pfam = PathFamily(graph, label)
                pfam_cache[label] = pfam
            if pfam.contains_path(path):
                read.graph_sequences_supported.append(label)
