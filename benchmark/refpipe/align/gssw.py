"""Graph striped Smith-Waterman: exact scalar/numpy engine.

This module re-derives the algorithm of gssw
(the reference's external/gssw/gssw.c) with exact integer arithmetic:

Fill (per node, topological order; gssw.c:153-455, 3963-4028):
  H(i,j) = max(0, H(i-1,j-1) + s(ref_i, read_j), E_i(j), F(i,j))
  E_i(j) = max(0, E_{i-1}(j) - gapE, H(i-1,j) - gapO)   [read gap / deletion]
  F(i,j) = max(0, F(i,j-1) - gapE, H(i,j-1) - gapO)     [ref gap / insertion]
with H(i,-1)=F(i,0)=0 and cross-node seeding: column -1 of a node is the
elementwise max over its predecessors' last H columns, and E_0 the max over
their outgoing E states (gssw_create_seed_byte, gssw.c:3897-3961).

The three matrices per node (H, E-used, F) are retained exactly as gssw
retains mH/mE/mF for its external traceback.

Traceback (gssw.c:1112-1818 within node, 2621-3530 across nodes): walks
from the best end cell preferring diagonal > ref-gap close > read-gap close
in H; open > extend inside gap states; crossing node boundaries via
predecessors in sorted-id order. Start position handling, terminal /
leading soft clips, N-handling ('N' op for N on either side) and the
mismatch 'X' op all match the reference byte-for-byte at the CIGAR level.

Scoring defaults (GraphAligner.cpp:230-233): match 1, mismatch 4 (as
penalty), gap open 6, gap extend 1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.model import SequenceGraph

# nt_table semantics: non-ACGT -> 4 ("N" class, scores 0 vs everything)
_NT = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _NT[ord(c)] = i


def make_score_matrix(match: int = 1, mismatch: int = 4) -> np.ndarray:
    """5x5 scoring matrix (gssw_create_score_matrix, gssw.c:4188-4204)."""
    mat = np.zeros((5, 5), dtype=np.int32)
    for l in range(4):
        for m in range(4):
            mat[l, m] = match if l == m else -mismatch
    return mat


@dataclass
class NodeFill:
    """Per-node fill result (mirrors gssw_align: mH/mE/mF + seed + ends)."""

    H: np.ndarray  # (node_len, read_len)
    E: np.ndarray  # E value used at each column
    F: np.ndarray
    last_H: np.ndarray  # H of last column (seed.pvHStore)
    next_E: np.ndarray  # E state after last column (seed.pvE)
    score1: int = 0
    ref_end1: int = -1
    read_end1: int = -1


@dataclass
class GraphMapping:
    score: int = 0
    position: int = 0  # start offset in first node
    node_ids: List[int] = field(default_factory=list)
    node_cigars: List[List[Tuple[int, str]]] = field(default_factory=list)

    def cigar_string(self) -> str:
        """node-CIGAR string, e.g. "0[10S40M]1[5M]" (extractCigar,
        GraphAligner.cpp:88-108)."""
        parts = []
        for node_id, cig in zip(self.node_ids, self.node_cigars):
            ops = "".join(f"{l}{t}" for l, t in cig)
            parts.append(f"{node_id}[{ops}]")
        return "".join(parts)


class _Cigar:
    """Run-merged cigar builder (gssw_cigar_push_back/front)."""

    def __init__(self):
        self.ops: List[Tuple[int, str]] = []

    def push_back(self, t: str, l: int):
        if self.ops and self.ops[-1][1] == t:
            self.ops[-1] = (self.ops[-1][0] + l, t)
        else:
            self.ops.append((l, t))

    def push_front(self, t: str, l: int):
        if self.ops and self.ops[0][1] == t:
            self.ops[0] = (self.ops[0][0] + l, t)
        else:
            self.ops.insert(0, (l, t))

    def reversed(self) -> List[Tuple[int, str]]:
        return list(reversed(self.ops))


class GraphSW:
    """Graph Smith-Waterman over one SequenceGraph (one strand).

    By default node expansion is 1:1 (paragraph builds
    graphtools::Graph without degenerate expansion, GraphInput.cpp:62),
    so gssw node ids equal graph node ids and predecessor order is
    sorted-id order (GraphAligner.cpp:110-167 + std::set iteration).

    With ``expand_degenerate=True`` the engine scores the IUPAC
    expansion of the graph instead (graph-tools
    SequenceOperations.cpp:155-190 enumeration; one scoring node per
    concrete expansion, all mapped back to the original node id like
    GraphAligner.cpp:125-133), and trace_back reports original node
    ids. ``node_map[i]`` is the original node of scoring node i.
    """

    def __init__(self, graph: SequenceGraph, match=1, mismatch=4,
                 gap_open=6, gap_extend=1, expand_degenerate=False):
        self.node_map = None
        if expand_degenerate:
            from ..graph.expand import expand_graph

            graph, self.node_map = expand_graph(graph)
        self.graph = graph
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.mat = make_score_matrix(match, mismatch)
        self.node_seqs = [s.upper() for s in graph.node_seqs]
        self.node_nums = [
            _NT[np.frombuffer(s.encode(), dtype=np.uint8)]
            for s in self.node_seqs
        ]
        self.preds = [graph.predecessors(i) for i in range(graph.num_nodes)]

    # ---------------- fill ----------------

    def fill(self, read: str) -> Tuple[List[NodeFill], int, int]:
        """Fill all nodes; returns (fills, max_node_id, max_score).

        max_node is the first node (in topological order) whose score
        strictly exceeds all previous (gssw_graph_fill_internal,
        gssw.c:4016-4020).
        """
        read = read.upper()
        read_num = _NT[np.frombuffer(read.encode(), dtype=np.uint8)]
        m_real = len(read_num)
        # gssw pads the read to 16*segLen striped lanes whose profile score
        # is 0 against every reference base (gssw_qP_byte, gssw.c:91).
        # These lanes echo scores diagonally into successor nodes' matrices
        # and participate in the per-node column maxima, so we model them
        # as score-0 tail positions to match score1/ref_end1 exactly.
        seg_len = (m_real + 15) // 16
        m = seg_len * 16
        gapO, gapE = self.gap_open, self.gap_extend
        # profile[c] = score vector over read positions for ref char class c
        profile = np.zeros((5, m), dtype=np.int32)
        profile[:, :m_real] = self.mat[:, read_num]

        fills: List[NodeFill] = []
        max_node = -1
        max_score = 0
        jj = np.arange(1, m, dtype=np.int64)
        for nid in range(self.graph.num_nodes):
            ref_num = self.node_nums[nid]
            n = len(ref_num)
            preds = self.preds[nid]
            if preds:
                seed_H = fills[preds[0]].last_H.copy()
                seed_E = fills[preds[0]].next_E.copy()
                for p in preds[1:]:
                    np.maximum(seed_H, fills[p].last_H, out=seed_H)
                    np.maximum(seed_E, fills[p].next_E, out=seed_E)
            else:
                seed_H = np.zeros(m, dtype=np.int32)
                seed_E = np.zeros(m, dtype=np.int32)

            H = np.zeros((n, m), dtype=np.int32)
            E = np.zeros((n, m), dtype=np.int32)
            F = np.zeros((n, m), dtype=np.int32)
            h_prev = seed_H
            e_col = seed_E
            score1 = 0
            ref_end1 = -1
            read_end1 = m_real - 1
            best_col: Optional[np.ndarray] = None
            for i in range(n):
                prof = profile[ref_num[i]]
                # H without F contribution
                hp = np.empty(m, dtype=np.int32)
                hp[0] = max(0, prof[0])  # diag source H(i-1,-1) = 0
                np.add(h_prev[:-1], prof[1:], out=hp[1:])
                np.maximum(hp, 0, out=hp)
                np.maximum(hp, e_col, out=hp)
                # F scan: F(j) = max(0, max_{k<j} hp(k) - gapO - (j-1-k)gapE)
                # (F never chains off F-derived H when gapO >= gapE)
                f = np.zeros(m, dtype=np.int32)
                if m > 1:
                    A = hp[:-1] - gapO + jj * gapE
                    np.maximum.accumulate(A, out=A)
                    np.subtract(A, jj * gapE, out=A)
                    np.maximum(A, 0, out=f[1:])
                h = np.maximum(hp, f)
                H[i] = h
                E[i] = e_col
                F[i] = f
                # E for next column
                e_col = np.maximum(e_col - gapE, h - gapO)
                np.maximum(e_col, 0, out=e_col)
                h_prev = h
                cm = int(h.max()) if m else 0
                if cm > score1:
                    score1 = cm
                    ref_end1 = i
                    best_col = h.copy()
            if best_col is not None:
                w = np.flatnonzero(best_col == score1)
                if len(w) and w[0] < read_end1:
                    read_end1 = int(w[0])
            else:
                # all-zero matrix: gssw scans its zero-initialised pvHmax
                # buffer for values == 0 and finds position 0 (gssw.c:445-454)
                read_end1 = 0 if m_real > 1 else read_end1
            # Traceback and uniqueness only see the real read positions;
            # padded lanes are kept in last_H/next_E for seed propagation.
            fills.append(NodeFill(H[:, :m_real], E[:, :m_real],
                                  F[:, :m_real], h_prev, e_col,
                                  score1, ref_end1, read_end1))
            if max_node < 0 or score1 > max_score:
                max_node = nid
                max_score = score1
        return fills, max_node, max_score

    # ---------------- uniqueness ----------------

    def ends_at_multiple_nodes(self, fills: List[NodeFill], top: int) -> bool:
        """Does the top score appear in >1 distinct node
        (alignsEndAtMultNodes, GraphAligner.cpp:170-212)?"""
        seen = 0
        for f in fills:
            if f.H.size and (f.H == top).any():
                seen += 1
                if seen > 1:
                    return True
        return False

    # ---------------- traceback ----------------

    def trace_back_pinned(self, fills: List[NodeFill], pinned_node: int,
                          read: str) -> GraphMapping:
        """gssw_graph_trace_back_pinned (gssw.h:487-494): the traceback
        is anchored at the cell where the read's LAST base aligns to the
        LAST base of `pinned_node`, instead of the global maximum —
        the walk back through the filled matrices is identical."""
        read = read.upper()
        f = fills[pinned_node]
        ref_end = len(self.node_seqs[pinned_node]) - 1
        read_end = len(read) - 1
        return self._trace_from(fills, pinned_node, ref_end, read_end,
                                read)

    def trace_back(self, fills: List[NodeFill], max_node: int,
                   read: str) -> GraphMapping:
        f = fills[max_node]
        return self._trace_from(fills, max_node, f.ref_end1, f.read_end1,
                                read)

    def _trace_from(self, fills: List[NodeFill], n_id: int,
                    ref_end: int, read_end: int, read: str
                    ) -> GraphMapping:
        read = read.upper()
        m = len(read)
        gapO, gapE = self.gap_open, self.gap_extend
        mat = self.mat

        f = fills[n_id]
        if ref_end < 0 or read_end < 0:
            score = 0
        else:
            score = int(f.H[ref_end, read_end])

        gm = GraphMapping(score=score)
        node_ids_rev: List[int] = []
        cigars_rev: List[_Cigar] = []

        gap_in_read = False

        end_soft_clip = m - read_end - 1

        def align_score(nid, i, j):
            return int(mat[self.node_nums[nid][i], _NT[ord(read[j])]])

        def op_for(nid, i, j):
            rc = self.node_seqs[nid][i]
            qc = read[j]
            if rc == "N" or qc == "N":
                return "N"
            return "M" if rc == qc else "X"

        while score > 0:
            f = fills[n_id]
            H, E, F = f.H, f.E, f.F
            cig = _Cigar()
            i, j = ref_end, read_end
            g_read, g_ref = gap_in_read, False
            if g_read:
                score_here = int(E[i, j])
            else:
                score_here = int(H[i, j])

            # ---- within-node walk (gssw_alignment_trace_back_byte) ----
            while score_here > 0 and i >= 0 and j >= 0:
                if g_read:
                    if i > 0:
                        if score_here == int(H[i - 1, j]) - gapO:
                            cig.push_back("D", 1)
                            score_here += gapO
                            i -= 1
                            g_read = False
                            continue
                        if score_here == int(E[i - 1, j]) - gapE:
                            cig.push_back("D", 1)
                            score_here += gapE
                            i -= 1
                            continue
                        raise AssertionError("stuck in read gap")
                    break  # cross node boundary in gap
                if g_ref:
                    if j > 0:
                        if score_here == int(H[i, j - 1]) - gapO:
                            cig.push_back("I", 1)
                            score_here += gapO
                            j -= 1
                            g_ref = False
                            continue
                        if score_here == int(F[i, j - 1]) - gapE:
                            cig.push_back("I", 1)
                            score_here += gapE
                            j -= 1
                            continue
                    raise AssertionError("stuck in ref gap")
                # in H
                a = align_score(n_id, i, j)
                found = False
                if i > 0 and j > 0:
                    if score_here == int(H[i - 1, j - 1]) + a:
                        cig.push_back(op_for(n_id, i, j), 1)
                        score_here -= a
                        i -= 1
                        j -= 1
                        found = True
                else:
                    if score_here == a:
                        # alignment start cell (gssw.c:1655-1690)
                        rc = self.node_seqs[n_id][i]
                        qc = read[j]
                        if rc == "N" or qc == "N":
                            cig.push_back("N", 1)
                        elif rc == qc:
                            cig.push_back("M", 1)
                        score_here -= a
                        i -= 1
                        j -= 1
                        found = True
                if found:
                    continue
                if j > 0 and score_here == int(F[i, j]):
                    g_ref = True
                    continue
                if score_here == int(E[i, j]):
                    g_read = True
                    continue
                if i == 0:
                    break  # cross node boundary diagonally
                raise AssertionError("stuck in main matrix")

            # within-node walk built the cigar backwards; flip to forward
            # order (gssw_reverse_cigar at end of trace_back_byte)
            cig.ops.reverse()

            if end_soft_clip:
                cig.push_back("S", end_soft_clip)
                end_soft_clip = 0
            node_ids_rev.append(n_id)
            cigars_rev.append(cig)

            ref_end, read_end = i, j
            gap_in_read = g_read
            score = score_here
            if score != 0 and ref_end > 0:
                raise AssertionError("traceback stopped mid-matrix")
            if score == 0:
                if read_end > -1:
                    cig.push_front("S", read_end + 1)
                break

            # ---- cross node boundary (gssw.c:2949-3175) ----
            best_prev = -1
            for cn in self.preds[n_id]:
                cf = fills[cn]
                if not gap_in_read:
                    # Diagonal match/mismatch into the predecessor's last
                    # column. NB the reference reads mH[...-1] for
                    # read_end==0 (uninitialised memory); a legitimate
                    # crossing there is impossible because score==a starts
                    # are consumed within the node, so we only test
                    # read_end > 0.
                    if read_end > 0:
                        a = align_score(n_id, ref_end, read_end)
                        diag = int(cf.H[-1, read_end - 1])
                        if score == diag + a:
                            best_prev = cn
                            cig.push_front(op_for(n_id, ref_end, read_end), 1)
                            score -= a
                            read_end -= 1
                            break
                else:
                    open_src = int(cf.H[-1, read_end])
                    if score == open_src - gapO:
                        best_prev = cn
                        cig.push_front("D", 1)
                        score += gapO
                        gap_in_read = False
                        break
                    ext_src = int(cf.E[-1, read_end])
                    if score == ext_src - gapE:
                        best_prev = cn
                        cig.push_front("D", 1)
                        score += gapE
                        break
            if best_prev < 0:
                if score > 0:
                    raise AssertionError("no valid previous node")
                if read_end > -1:
                    cig.push_front("S", read_end + 1)
                break
            n_id = best_prev
            ref_end = len(self.node_seqs[n_id]) - 1

        gm.position = ref_end + 1 if ref_end + 1 >= 0 else 0
        gm.node_ids = list(reversed(node_ids_rev))
        if self.node_map is not None:
            gm.node_ids = [self.node_map[i] for i in gm.node_ids]
        gm.node_cigars = [c.ops for c in reversed(cigars_rev)]
        return gm

    def align(self, read: str) -> Tuple[GraphMapping, bool]:
        """Fill + traceback + uniqueness; returns (mapping, multi_node_end).

        NB alignsEndAtMultNodes runs unconditionally in the reference
        (GraphAligner.cpp:226), so a zero-score fill reports multi=True
        (every all-zero cell "attains" the top score of 0).
        """
        fills, max_node, max_score = self.fill(read)
        multi = self.ends_at_multiple_nodes(fills, max_score)
        gm = self.trace_back(fills, max_node, read)
        return gm, multi

    def align_pinned(self, read: str, pinned_node: int) -> GraphMapping:
        """gssw_graph_trace_back_pinned equivalent: best alignment whose
        last read base sits on the last base of `pinned_node`."""
        fills, _, _ = self.fill(read)
        return self.trace_back_pinned(fills, pinned_node, read)

    def align_pinned_multi(self, read: str, pinned_node: int,
                           num_tracebacks: int,
                           max_expansions: int = 200000
                           ) -> List[GraphMapping]:
        """gssw_graph_trace_back_pinned_multi (gssw.h:506-516)
        equivalent: the `num_tracebacks` highest-scoring DISTINCT
        alignments ending with the read's final base on the final base
        of `pinned_node`, in descending score order.

        Exact branch-and-bound over the filled DP: paths are enumerated
        backward from the pinned cell, using each cell's H value — the
        best score of ANY alignment ending there — as an admissible
        completion bound, so only paths competitive with the current
        k-th best are expanded. Alignments start and end on
        match/mismatch ops (the read prefix above the start soft-clips),
        matching gssw's traceback shape.
        """
        import heapq

        read_u = read.upper()
        read_num = _NT[np.frombuffer(read_u.encode(), dtype=np.uint8)]
        m = len(read_num)
        if m == 0 or not self.node_seqs[pinned_node]:
            return []
        fills, _, _ = self.fill(read_u)
        mat = self.mat
        gapO, gapE = self.gap_open, self.gap_extend
        # completed alignments: min-heap of (score, tiebreak, payload)
        heap: List = []
        counter = [0]
        expansions = [0]

        def offer(score, trail):
            counter[0] += 1
            item = (score, -counter[0], trail)
            if len(heap) < num_tracebacks:
                heapq.heappush(heap, item)
            elif score > heap[0][0]:
                heapq.heapreplace(heap, item)

        def kth_best():
            return heap[0][0] if len(heap) == num_tracebacks else None

        def preds_cells(node, i):
            """Cells one ref-step left of (node, i): same node or the
            last column of each predecessor when i == 0."""
            if i > 0:
                return [(node, i - 1)]
            return [(p, len(self.node_seqs[p]) - 1)
                    for p in self.preds[node]]

        def walk(node, i, j, suffix, trail, last_op, gaps_ok=True):
            """Extend the alignment one op backward; the next op
            consumes cell (node, i, j). trail is a linked list
            (op, node, ref_i, prev) with the alignment's FIRST op at
            its head."""
            if expansions[0] > max_expansions or i < 0 or j < 0:
                return
            expansions[0] += 1
            k = kth_best()
            # H[i, j] = best score of ANY alignment ending at this cell:
            # an exact admissible bound for the remaining prefix
            if k is not None and suffix + int(fills[node].H[i, j]) <= k:
                return
            # diagonal M/X consuming ref i + read j
            rc = int(self.node_nums[node][i])
            qc = int(read_num[j])
            s = int(mat[rc, qc])
            op = "M" if (rc == qc and qc < 4) else "X"
            new_trail = (op, node, i, trail)
            total = suffix + s
            if s > 0 and (k is None or total > k):
                offer(total, new_trail)  # alignment may start here
            if j - 1 >= 0:
                for pn, pi in preds_cells(node, i):
                    walk(pn, pi, j - 1, total, new_trail, op)
            if not gaps_ok:
                return
            # read gap (I): consumes read j only, stays on ref i
            cost = -(gapE if last_op == "I" else gapO)
            walk(node, i, j - 1, suffix + cost,
                 ("I", node, i, trail), "I")
            # ref gap (D): consumes ref i only, stays on read j
            cost = -(gapE if last_op == "D" else gapO)
            for pn, pi in preds_cells(node, i):
                walk(pn, pi, j, suffix + cost,
                     ("D", node, i, trail), "D")

        # the pinned cell: last read base on the last node base, and
        # the final op is by definition a diagonal one
        walk(pinned_node, len(self.node_seqs[pinned_node]) - 1, m - 1,
             0, None, "", gaps_ok=False)

        out = []
        for score, _tb, trail in sorted(heap, reverse=True):
            ops = []  # alignment order: trail head is the first op
            cur = trail
            while cur is not None:
                op, node, i, prev = cur
                ops.append((op, node, i))
                cur = prev
            _, _, start_i, _ = trail
            gm = GraphMapping(score=score)
            gm.position = start_i
            node_ids: List[int] = []
            cigars: List[_Cigar] = []
            for op, node, i in ops:
                if not node_ids or node_ids[-1] != node:
                    node_ids.append(node)
                    cigars.append(_Cigar())
                cigars[-1].push_back(op, 1)
            j_start = m - sum(1 for op, _, _ in ops if op in "MXI")
            if j_start > 0:
                cigars[0].push_front("S", j_start)
            gm.node_ids = node_ids
            gm.node_cigars = [c.ops for c in cigars]
            out.append(gm)
        return out
