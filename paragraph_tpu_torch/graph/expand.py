"""Degenerate-base (IUPAC) node expansion.

graph-tools expands nodes whose sequences carry degenerate nucleotide
symbols into one concrete ACGT sequence per combination
(src/graphutils/SequenceOperations.cpp:90-190), and grm::GraphAligner
builds one gssw node per expansion, mapping them all back to the
original node id (GraphAligner.cpp:110-167). The paragraph CLI itself
builds its graphs with expansion disabled (GraphInput.cpp:62), so the
production realignment path is 1:1; expansion is the library capability
used by gapped/pinned alignment over degenerate reference assemblies.

The enumeration ORDER of expansions is part of the contract: gssw node
ids follow it, and alignment tie-breaking follows gssw node ids.
Reference order: walk the sequence left to right; the symbol's first
concrete base extends every accumulated expansion in place, and each
further concrete base appends a copy of every pre-extension expansion.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .model import SequenceGraph

#: IUPAC symbol → concrete expansion bases, in reference enumeration
#: order (SequenceOperations.cpp:90-93). X is the non-matching padding
#: symbol and expands to itself.
SYMBOL_EXPANSION: Dict[str, str] = {
    "A": "A", "C": "C", "T": "T", "G": "G",
    "R": "AG", "Y": "CT", "K": "GT", "M": "AC", "S": "CG", "W": "AT",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
    "X": "X",
}


def is_reference_sequence(seq: str) -> bool:
    return all(c in SYMBOL_EXPANSION for c in seq.upper())


def has_degenerate_symbols(seq: str) -> bool:
    return any(len(SYMBOL_EXPANSION.get(c, c)) > 1 for c in seq.upper())


def expand_sequence(seq: str) -> List[str]:
    """All concrete expansions of one degenerate sequence, in the
    reference's enumeration order."""
    s = seq.upper()
    if not has_degenerate_symbols(s):
        return [seq]
    expansions = [""]
    for symbol in s:
        bases = SYMBOL_EXPANSION.get(symbol)
        if bases is None:
            raise ValueError(
                f"Symbol {symbol} is not a valid reference symbol")
        expansions = [e + bases[0] for e in expansions]
        n_before = len(expansions)
        for extra in bases[1:]:
            expansions.extend(e[:-1] + extra
                              for e in expansions[:n_before])
    return expansions


def expand_graph(graph: SequenceGraph
                 ) -> Tuple[SequenceGraph, List[int]]:
    """Expanded scoring graph + node map back to the original ids.

    One node per (interior-node expansion); the first and last node are
    taken verbatim like grm::GraphAligner does for source/sink
    (GraphAligner.cpp:123-142). Every edge (u, v) becomes the complete
    bipartite set between u's and v's expansions. Expansions of one
    node are consecutive, so topological node order is preserved.
    """
    n = graph.num_nodes
    names: List[str] = []
    seqs: List[str] = []
    node_map: List[int] = []
    first_expanded: List[int] = []
    for node_id in range(n):
        first_expanded.append(len(names))
        seq = graph.node_seq(node_id)
        variants = ([seq] if node_id in (0, n - 1)
                    else expand_sequence(seq))
        for k, v in enumerate(variants):
            names.append(graph.node_name(node_id) if len(variants) == 1
                         else f"{graph.node_name(node_id)}#{k}")
            seqs.append(v)
            node_map.append(node_id)
    first_expanded.append(len(names))

    out = SequenceGraph(names, seqs)
    for (f, t) in graph.edges():
        for ef in range(first_expanded[f], first_expanded[f + 1]):
            for et in range(first_expanded[t], first_expanded[t + 1]):
                out.add_edge(ef, et)
                for label in graph.edge_labels(f, t):
                    out.add_label_to_edge(ef, et, label)
    return out, node_map
