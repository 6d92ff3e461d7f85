"""Node-CIGAR codec and per-node alignment accounting.

Equivalent of graph-tools' LinearAlignment / GraphAlignment /
GraphAlignmentOperations (decode of strings like ``0[5S10M]1[4M1X]``,
graph-tools src/graphalign/GraphAlignmentOperations.cpp:84-118) with the
same operation classes: M match, X mismatch, N missing bases, I insertion
to ref, D deletion from ref, S soft clip.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MXNIDS])")
_NODE_RE = re.compile(r"(\d+)\[([^\]]*)\]")

_QUERY_OPS = set("MXNIS")
_REF_OPS = set("MXND")


class NodeAlignment:
    """Per-node linear alignment with counts computed once up front.

    The host analysis stages (filters, disambiguation, counting,
    statistics) read the count attributes several times per node, so
    one pass over ops at construction beats lazy per-property sums.
    ops must not be mutated after construction (nothing in the
    pipeline does; gssw traceback builds its own op runs first)."""

    __slots__ = ("reference_start", "ops", "num_matched",
                 "num_mismatched", "num_missing", "num_clipped",
                 "num_inserted", "num_deleted", "query_length",
                 "reference_length")

    def __init__(self, reference_start: int, ops: List[Tuple[int, str]]):
        self.reference_start = reference_start
        self.ops = ops
        m = x = n = s = i = d = 0
        for l, t in ops:
            if t == "M":
                m += l
            elif t == "X":
                x += l
            elif t == "N":
                n += l
            elif t == "S":
                s += l
            elif t == "I":
                i += l
            else:
                d += l
        self.num_matched = m
        self.num_mismatched = x
        self.num_missing = n
        self.num_clipped = s
        self.num_inserted = i
        self.num_deleted = d
        self.query_length = m + x + n + i + s
        self.reference_length = m + x + n + d

    def _count(self, op: str) -> int:
        return {"M": self.num_matched, "X": self.num_mismatched,
                "N": self.num_missing, "S": self.num_clipped,
                "I": self.num_inserted, "D": self.num_deleted}[op]

    def __eq__(self, other):
        return (isinstance(other, NodeAlignment)
                and self.reference_start == other.reference_start
                and self.ops == other.ops)

    def __repr__(self):
        return (f"NodeAlignment(reference_start="
                f"{self.reference_start}, ops={self.ops!r})")

    def generate_cigar(self) -> str:
        return "".join(f"{l}{t}" for l, t in self.ops)


@dataclass
class GraphAlignment:
    """Decoded graph alignment: path node ids + per-node linear alignments."""

    node_ids: List[int]
    alignments: List[NodeAlignment]
    path_start: int  # offset of first aligned base in first node
    path_end: int  # offset of last aligned base in last node

    @property
    def query_length(self) -> int:
        memo = getattr(self, "_qlen_memo", None)
        if memo is None:
            memo = sum(a.query_length for a in self.alignments)
            self._qlen_memo = memo
        return memo

    @property
    def reference_length(self) -> int:
        memo = getattr(self, "_rlen_memo", None)
        if memo is None:
            memo = sum(a.reference_length for a in self.alignments)
            self._rlen_memo = memo
        return memo

    def generate_cigar(self) -> str:
        return "".join(
            f"{nid}[{a.generate_cigar()}]"
            for nid, a in zip(self.node_ids, self.alignments))

    def __len__(self):
        return len(self.node_ids)


def parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    pos = 0
    out = []
    for m in _CIGAR_RE.finditer(cigar):
        if m.start() != pos:
            raise ValueError(f"Bad CIGAR: {cigar}")
        out.append((int(m.group(1)), m.group(2)))
        pos = m.end()
    if pos != len(cigar):
        raise ValueError(f"Bad CIGAR: {cigar}")
    return out


def decode_read_alignment(read) -> "GraphAlignment":
    """decode_graph_alignment of a Read's current mapping, memoised on the
    (pos, cigar) pair (the host pipeline decodes each mapping ~4×:
    filters, disambiguation, fragment counting, statistics)."""
    memo = getattr(read, "_decoded_alignment", None)
    if memo is not None and memo[0] == read.graph_pos \
            and memo[1] == read.graph_cigar:
        return memo[2]
    decoded = decode_graph_alignment(read.graph_pos, read.graph_cigar)
    read._decoded_alignment = (read.graph_pos, read.graph_cigar, decoded)
    return decoded


def decode_graph_alignment(first_node_start: int, graph_cigar: str
                           ) -> GraphAlignment:
    node_ids = []
    alignments = []
    pos = 0
    for m in _NODE_RE.finditer(graph_cigar):
        if m.start() != pos:
            raise ValueError(f"Bad graph CIGAR: {graph_cigar}")
        pos = m.end()
        node_ids.append(int(m.group(1)))
        ref_pos = first_node_start if not alignments else 0
        alignments.append(NodeAlignment(ref_pos, parse_cigar(m.group(2))))
    if pos != len(graph_cigar) or not node_ids:
        raise ValueError(f"Bad graph CIGAR: {graph_cigar}")
    last = alignments[-1]
    path_end = last.reference_start + last.reference_length - 1
    return GraphAlignment(node_ids, alignments, first_node_start, path_end)
