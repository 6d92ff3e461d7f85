"""graph-tools-flavour graph JSON load/save.

Equivalent of graph-tools' graphIO GraphJson
(graph-tools src/graphIO/GraphJson.cpp, 105 LoC): the plain
{nodes: [{name, sequence}], edges: [{from, to, labels?}]} encoding used
by the library itself — distinct from paragraph's richer graph
description (reference regions, paths, target regions) handled by
SequenceGraph.from_json.
"""
from __future__ import annotations

import gzip
import json
from typing import Dict

from .model import SequenceGraph


def parse_graph(desc: dict) -> SequenceGraph:
    """parseGraph (GraphJson.cpp:44-77): node names must be unique;
    sequences are optional (default empty)."""
    nodes = desc["nodes"]
    names = [n["name"] for n in nodes]
    if len(set(names)) != len(names):
        raise ValueError("duplicate node names in graph JSON")
    seqs = [n.get("sequence", "") for n in nodes]
    ids: Dict[str, int] = {name: i for i, name in enumerate(names)}
    graph = SequenceGraph(names, seqs)
    for edge in desc.get("edges", []):
        n1 = ids[edge["from"]]
        n2 = ids[edge["to"]]
        graph.add_edge(n1, n2)
        for label in edge.get("labels", []):
            graph.add_label_to_edge(n1, n2, label)
    return graph


def load_graph(json_path: str) -> SequenceGraph:
    """loadGraph (GraphJson.cpp:34-42): accepts the graph as the
    top-level object or nested under 'graph'."""
    opener = gzip.open if json_path.endswith(".gz") else open
    with opener(json_path, "rt") as f:
        desc = json.load(f)
    return parse_graph(desc.get("graph", desc))


def graph_to_json(graph: SequenceGraph) -> dict:
    """graphToJson (GraphJson.cpp:79-104): edges carry labels only when
    non-empty; edge order follows (from, to) node id order."""
    nodes = [{"name": graph.node_name(i), "sequence": graph.node_seq(i)}
             for i in range(graph.num_nodes)]
    edges = []
    for n1 in range(graph.num_nodes):
        for n2 in sorted(graph.successors(n1)):
            edge = {"from": graph.node_name(n1), "to": graph.node_name(n2)}
            labels = sorted(graph.edge_labels(n1, n2))
            if labels:
                edge["labels"] = labels
            edges.append(edge)
    return {"nodes": nodes, "edges": edges}
