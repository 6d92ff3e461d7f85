"""Linear Smith-Waterman aligner against enumerated path sequences.

Equivalent of ``grm::KlibAligner``
(the reference's src/c++/lib/grm/KlibAligner.cpp): each path's linear
sequence is aligned against the read with affine-gap local SW (klib ksw
parameters: match 1, mismatch −4, gap open 5, gap extend 1,
KlibAligner.cpp:137-142), soft clips added for unaligned query ends, the
linear CIGAR lifted onto the path's nodes, and the best-scoring candidate
kept (ties with different placements → non-unique / BAD_ALIGN).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..graph.model import SequenceGraph
from ..reads.read import Read, MAPPED, UNMAPPED, BAD_ALIGN
from .graph_aligner import reverse_complement

MATCH = 1
MISMATCH = 4
GAP_OPEN = 5
GAP_EXTEND = 1


def linear_sw(ref: str, query: str, match: int = MATCH,
              mismatch: int = MISMATCH, gap_open: int = GAP_OPEN,
              gap_extend: int = GAP_EXTEND):
    """Affine local SW returning (score, r0, r1, a0, a1, cigar ops) with
    ksw-style semantics (gap cost = gapO + k*gapE for k bases, i.e. first
    gap base costs gapO+gapE). Defaults are grm::KlibAligner's scores
    (KlibAligner.cpp:138-142); the generic common::Alignment klib wrapper
    uses (2, 2, 3, 1) (Alignment.hh:43-44).

    N bases score 0 against everything (AlignmentParameters subs_mat
    N row/column, Alignment.hh:47-53)."""
    MATCH, MISMATCH = match, mismatch
    GAP_OPEN, GAP_EXTEND = gap_open, gap_extend
    n, m = len(ref), len(query)
    NEG = -(10 ** 9)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int32)  # gap in query (D)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int32)  # gap in ref (I)
    best = 0
    best_cell = (0, 0)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i][j] = max(E[i - 1][j] - GAP_EXTEND,
                          H[i - 1][j] - GAP_OPEN - GAP_EXTEND)
            F[i][j] = max(F[i][j - 1] - GAP_EXTEND,
                          H[i][j - 1] - GAP_OPEN - GAP_EXTEND)
            if ref[i - 1] == "N" or query[j - 1] == "N":
                s = 0
            elif ref[i - 1] == query[j - 1]:
                s = MATCH
            else:
                s = -MISMATCH
            h = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            H[i][j] = h
            if h > best:
                best = h
                best_cell = (i, j)
    if best == 0:
        return 0, -1, -2, -1, -2, []
    i, j = best_cell
    r1, a1 = i - 1, j - 1
    ops: List[Tuple[int, str]] = []

    def push(op):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))

    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            if H[i][j] == 0:
                break
            if ref[i - 1] == "N" or query[j - 1] == "N":
                s = 0
            elif ref[i - 1] == query[j - 1]:
                s = MATCH
            else:
                s = -MISMATCH
            if H[i][j] == H[i - 1][j - 1] + s:
                push("M")
                i -= 1
                j -= 1
            elif H[i][j] == E[i][j]:
                state = "E"
            elif H[i][j] == F[i][j]:
                state = "F"
            else:
                break
        elif state == "E":
            push("D")
            if E[i][j] == H[i - 1][j] - GAP_OPEN - GAP_EXTEND:
                state = "H"
            i -= 1
        else:
            push("I")
            if F[i][j] == H[i][j - 1] - GAP_OPEN - GAP_EXTEND:
                state = "H"
            j -= 1
    r0, a0 = i, j
    ops.reverse()
    return best, r0, r1, a0, a1, ops


@dataclass
class _Candidate:
    path_id: int
    position: int
    reverse: bool
    score: int
    ops: List[Tuple[int, str]]  # includes leading/trailing S
    a0: int
    a1: int


class KlibAligner:
    def __init__(self):
        self.graph: Optional[SequenceGraph] = None
        self.paths = []
        self.attempted = 0
        self.mapped = 0

    def set_graph(self, graph: SequenceGraph, paths):
        self.graph = graph
        self.paths = []
        for pid, node_ids in enumerate(paths or []):
            seq = ""
            starts = []
            for nid in node_ids:
                starts.append((len(seq), nid))
                seq += graph.node_seq(nid).upper()
            self.paths.append((pid, list(node_ids), seq, starts))

    def align_read(self, read: Read) -> None:
        self.attempted += 1
        read.graph_mapping_status = UNMAPPED
        bases = read.bases
        rv = reverse_complement(bases)
        candidates: List[_Candidate] = []
        for pid, node_ids, seq, starts in self.paths:
            for reverse, q in ((False, bases), (True, rv)):
                score, r0, r1, a0, a1, ops = linear_sw(seq, q)
                if r1 < r0:
                    continue
                full_ops = []
                if a0:
                    full_ops.append((a0, "S"))
                full_ops.extend(ops)
                right_clip = len(q) - a1 - 1
                if right_clip:
                    full_ops.append((right_clip, "S"))
                candidates.append(_Candidate(pid, r0, reverse, score,
                                             full_ops, a0, a1))
        if not candidates:
            return
        best = max(candidates, key=lambda c: c.score)
        self._update_alignment(best, bases, rv, read)
        for c in candidates:
            if c is best or c.score != best.score:
                continue
            other = Read(bases=bases)
            self._update_alignment(c, bases, rv, other)
            if (other.graph_cigar != read.graph_cigar
                    or other.graph_pos != read.graph_pos):
                read.graph_mapq = 0
                read.is_graph_alignment_unique = False
                read.graph_mapping_status = BAD_ALIGN
                return
        self.mapped += 1

    def _update_alignment(self, cand: _Candidate, bases: str, rv: str,
                          read: Read):
        """buildGraphCigar (KlibAligner.cpp:210+): split the linear CIGAR
        at path-node boundaries."""
        pid, node_ids, seq, starts = self.paths[cand.path_id]
        pos = cand.position
        start_idx = 0
        for i, (off, _nid) in enumerate(starts):
            if off <= pos:
                start_idx = i
            else:
                break
        graph_pos = pos - starts[start_idx][0]
        cigar = ""
        node_ops: List[Tuple[int, str]] = []
        cur_node = start_idx
        node_end = (starts[cur_node + 1][0] if cur_node + 1 < len(starts)
                    else len(seq))
        ref_pos = pos

        def flush():
            nonlocal cigar, node_ops
            if node_ops:
                ops_s = "".join(f"{l}{t}" for l, t in node_ops)
                cigar += f"{starts[cur_node][1]}[{ops_s}]"
                node_ops = []

        def push(length, op):
            if node_ops and node_ops[-1][1] == op:
                node_ops[-1] = (node_ops[-1][0] + length, op)
            else:
                node_ops.append((length, op))

        for length, op in cand.ops:
            if op in ("S", "I"):
                push(length, op)
                continue
            while length > 0:
                avail = node_end - ref_pos
                take = min(length, avail)
                if take > 0:
                    push(take, op)
                    ref_pos += take
                    length -= take
                if length > 0:
                    flush()
                    cur_node += 1
                    node_end = (starts[cur_node + 1][0]
                                if cur_node + 1 < len(starts) else len(seq))
        flush()

        read.graph_pos = graph_pos
        if cand.reverse:
            read.bases = rv
            read.is_graph_reverse_strand = not read.is_reverse_strand
        else:
            read.is_graph_reverse_strand = read.is_reverse_strand
        read.graph_cigar = cigar
        read.graph_alignment_score = cand.score
        read.graph_mapq = 60
        read.is_graph_alignment_unique = True
        read.graph_mapping_status = MAPPED
