"""Kmer-seeded gapped graph alignment (graph-tools graphalign).

Library equivalent of graph-tools' ``GappedGraphAligner`` /
``PinnedAligner`` / ``TracebackMatrix`` stack
(graph-tools src/graphalign/GappedAligner.cpp:44-231,
PinnedAligner.cpp:36-134, TracebackRunner.cpp:40-140): seed the query
on its first graph-unique kmer, enumerate all path extensions long
enough to hold the unaligned prefix/suffix plus gap padding, align each
piece with an end-pinned global-ish DP, keep every top-scoring
extension, and project the merged linear alignment back onto the graph
as node CIGARs. Dead-end extensions degrade to soft-clips exactly like
the reference.

Differences from graph-tools: paths are over our DAG ``SequenceGraph``
(no self-loop STR nodes — paragraph's graphs are DAGs, and so is every
other consumer in this framework), and the DP matrices fill with numpy
rows instead of a cell object matrix. Semantics the tests pin — cell
preference order (diagonal, then left, then top on strict improvement),
LAST-maximal top-cell choice, run-length traceback, soft-clip fallback
— follow the reference exactly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..graph.model import SequenceGraph
from .alignment import GraphAlignment, NodeAlignment
from .kmer_index import KmerIndex

# a path is (nodes tuple, start offset, end offset), offsets inclusive
Path = Tuple[Tuple[int, ...], int, int]

_STOP, _DIAG_M, _DIAG_X, _LEFT, _TOP = 0, 1, 2, 3, 4


def path_length(graph: SequenceGraph, path: Path) -> int:
    nodes, start, end = path
    if len(nodes) == 1:
        return end - start + 1
    total = len(graph.node_seq(nodes[0])) - start
    for nid in nodes[1:-1]:
        total += len(graph.node_seq(nid))
    return total + end + 1


def path_seq(graph: SequenceGraph, path: Path) -> str:
    nodes, start, end = path
    if len(nodes) == 1:
        return graph.node_seq(nodes[0])[start:end + 1]
    pieces = [graph.node_seq(nodes[0])[start:]]
    pieces.extend(graph.node_seq(n) for n in nodes[1:-1])
    pieces.append(graph.node_seq(nodes[-1])[:end + 1])
    return "".join(pieces)


def extend_path_start(graph: SequenceGraph, path: Path,
                      ext: int) -> List[Path]:
    """All paths reaching exactly `ext` bases further left
    (PathOperations.cpp:43-71); branches that dead-end early vanish."""
    nodes, start, end = path
    if ext <= start:
        return [(nodes, start - ext, end)]
    out: List[Path] = []
    leftover = ext - start - 1
    for pred in graph.predecessors(nodes[0]):
        plen = len(graph.node_seq(pred))
        out.extend(extend_path_start(
            graph, ((pred,) + nodes, plen - 1, end), leftover))
    return out


def extend_path_end(graph: SequenceGraph, path: Path,
                    ext: int) -> List[Path]:
    """Mirror image toward the right (PathOperations.cpp:73-103)."""
    nodes, start, end = path
    room = len(graph.node_seq(nodes[-1])) - end - 1
    if ext <= room:
        return [(nodes, start, end + ext)]
    out: List[Path] = []
    leftover = ext - room - 1
    for succ in graph.successors(nodes[-1]):
        out.extend(extend_path_end(
            graph, (nodes + (succ,), start, 0), leftover))
    return out


def shrink_path_start(graph: SequenceGraph, path: Path, n: int) -> Path:
    nodes, start, end = path
    while n > 0:
        room = (len(graph.node_seq(nodes[0])) - start
                if len(nodes) > 1 else end - start)
        if n <= room:
            return (nodes, start + n, end)
        n -= room
        nodes = nodes[1:]
        start = 0
    return (nodes, start, end)


def shrink_path_end(graph: SequenceGraph, path: Path, n: int) -> Path:
    nodes, start, end = path
    while n > 0:
        room = end + 1 if len(nodes) > 1 else end - start
        if n <= room:
            return (nodes, start, end - n)
        n -= room
        nodes = nodes[:-1]
        end = len(graph.node_seq(nodes[-1])) - 1
    return (nodes, start, end)


Ops = List[Tuple[int, str]]


def ops_ref_len(ops: Ops) -> int:
    return sum(l for l, t in ops if t in "MXND")


def ops_query_len(ops: Ops) -> int:
    return sum(l for l, t in ops if t in "MXNIS")


def merge_ops(a: Ops, b: Ops) -> Ops:
    if not a:
        return list(b)
    if not b:
        return list(a)
    out = list(a)
    if b and out[-1][1] == b[0][1]:
        out[-1] = (out[-1][0] + b[0][0], b[0][1])
        b = b[1:]
    out.extend(b)
    return out


def score_ops(ops: Ops, match: int, mismatch: int, gap: int) -> int:
    """LinearAlignmentOperations scoreAlignment: soft-clips score 0."""
    s = 0
    for l, t in ops:
        if t == "M":
            s += match * l
        elif t == "X":
            s += mismatch * l
        elif t in "ID":
            s += gap * l
    return s


class PinnedAligner:
    """End-pinned DP (PinnedAligner.cpp): global on the pinned side,
    free (soft-clipped) on the other."""

    def __init__(self, match: int = 5, mismatch: int = -4,
                 gap: int = -8):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap

    def _fill(self, ref: str, query: str):
        rows, cols = len(query) + 1, len(ref) + 1
        score = np.zeros((rows, cols), np.int32)
        step = np.zeros((rows, cols), np.int8)
        score[0, 1:] = np.arange(1, cols) * self.gap
        step[0, 1:] = _LEFT
        score[1:, 0] = np.arange(1, rows) * self.gap
        step[1:, 0] = _TOP
        r = np.frombuffer(ref.encode(), np.uint8)
        q = np.frombuffer(query.encode(), np.uint8)
        for i in range(1, rows):
            match_row = r == q[i - 1]
            diag = score[i - 1, :-1] + np.where(
                match_row, self.match, self.mismatch)
            step_row = np.where(match_row, _DIAG_M, _DIAG_X)
            top = score[i - 1, 1:] + self.gap
            # left gaps chain within the row: sequential scan; the
            # preference order is the reference's (PinnedAligner.cpp:
            # 87-110): diagonal, then LEFT on strict improvement, then
            # TOP on strict improvement over both
            prev = score[i, 0]
            srow = score[i]
            trow = step[i]
            for j in range(1, cols):
                v = diag[j - 1]
                st = step_row[j - 1]
                left = prev + self.gap
                if left > v:
                    v = left
                    st = _LEFT
                if top[j - 1] > v:
                    v = top[j - 1]
                    st = _TOP
                srow[j] = v
                trow[j] = st
                prev = v
        return score, step

    def prefix_align(self, ref: str, query: str) -> Tuple[int, Ops]:
        """Alignment pinned at (0,0); the query tail past the top cell
        soft-clips. Returns (ref_start, ops)."""
        score, step = self._fill(ref, query)
        # LAST maximal cell in row-major order (TracebackMatrix.cpp:
        # 107-124 uses <=)
        flat = score.size - 1 - int(np.argmax(score[::-1, ::-1]))
        i, j = divmod(flat, score.shape[1])
        ops: Ops = []
        if i != score.shape[0] - 1:
            ops.append((score.shape[0] - 1 - i, "S"))
        while step[i, j] != _STOP:
            cur = step[i, j]
            run = 0
            while step[i, j] == cur:
                run += 1
                if cur in (_DIAG_M, _DIAG_X):
                    i, j = i - 1, j - 1
                elif cur == _LEFT:
                    j -= 1
                else:
                    i -= 1
            ops.append((run, {_DIAG_M: "M", _DIAG_X: "X", _LEFT: "D",
                              _TOP: "I"}[cur]))
        if i != 0:
            ops.append((i, "S"))
        ops.reverse()
        return j, ops

    def suffix_align(self, ref: str, query: str) -> Tuple[int, Ops]:
        """Alignment pinned at the (ref_end, query_end) corner."""
        start_r, ops = self.prefix_align(ref[::-1], query[::-1])
        ops.reverse()
        return len(ref) - (start_r + ops_ref_len(ops)), ops


class GappedGraphAligner:
    """GappedGraphAligner (GappedAligner.cpp:44-231) over a DAG."""

    def __init__(self, graph: SequenceGraph, kmer_len: int,
                 padding_len: int, match: int = 5, mismatch: int = -4,
                 gap: int = -8):
        self.graph = graph
        self.kmer_len = kmer_len
        self.padding_len = padding_len
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.kmer_index = KmerIndex(graph, kmer_len)
        self.pinned = PinnedAligner(match, mismatch, gap)

    def align(self, query: str) -> List[GraphAlignment]:
        for pos in range(len(query) - self.kmer_len + 1):
            kmer = query[pos:pos + self.kmer_len]
            if self.kmer_index.num_paths(kmer) == 1:
                (nodes, s, e) = self.kmer_index.get_paths(kmer)[0]
                return self._extend_seed((tuple(nodes), s, e), query, pos)
        return []

    # ------------------------------------------------------------------

    def _best_extensions(self, candidates):
        top: List = []
        top_score = None
        for path, ops in candidates:
            sc = score_ops(ops, self.match, self.mismatch, self.gap)
            if top_score is None or sc > top_score:
                top, top_score = [], sc
            if sc == top_score:
                top.append((path, ops))
        return top

    def _extend_prefix(self, seed: Path, piece: str):
        """extendAlignmentPrefix (GappedAligner.cpp:149-188)."""
        ext = len(piece) + self.padding_len
        initial_len = path_length(self.graph, seed)
        cands = []
        for path in extend_path_start(self.graph, seed, ext):
            ref_piece = path_seq(self.graph, path)[:ext]
            _, ops = self.pinned.suffix_align(ref_piece, piece)
            cands.append((path, ops))
        out = []
        for path, ops in self._best_extensions(cands):
            overhang = (path_length(self.graph, path) - initial_len
                        - ops_ref_len(ops))
            out.append((shrink_path_start(self.graph, path, overhang),
                        ops))
        return out

    def _extend_suffix(self, seed: Path, piece: str):
        """extendAlignmentSuffix (GappedAligner.cpp:190-230)."""
        ext = len(piece) + self.padding_len
        initial_len = path_length(self.graph, seed)
        cands = []
        for path in extend_path_end(self.graph, seed, ext):
            ref_piece = path_seq(self.graph, path)[initial_len:]
            _, ops = self.pinned.prefix_align(ref_piece, piece)
            cands.append((path, ops))
        out = []
        for path, ops in self._best_extensions(cands):
            overhang = (path_length(self.graph, path) - initial_len
                        - ops_ref_len(ops))
            out.append((shrink_path_end(self.graph, path, overhang),
                        ops))
        return out

    def _extend_seed(self, kmer_path: Path, query: str,
                     kmer_start: int) -> List[GraphAlignment]:
        prefix = query[:kmer_start]
        suffix = query[kmer_start + self.kmer_len:]
        kmer_ops: Ops = [(self.kmer_len, "M")]

        with_prefix = []
        if prefix:
            for path, ops in self._extend_prefix(kmer_path, prefix):
                with_prefix.append((path, merge_ops(ops, kmer_ops)))
        if not with_prefix:
            ops = merge_ops([(len(prefix), "S")] if prefix else [],
                            kmer_ops)
            with_prefix.append((kmer_path, ops))

        full = []
        if suffix:
            for path, ops in with_prefix:
                for spath, sops in self._extend_suffix(path, suffix):
                    # the suffix extension replaces the path's tail;
                    # the prefix part of spath is identical to path
                    full.append((spath, merge_ops(ops, sops)))
        if not suffix:
            full = with_prefix
        elif not full:
            full = [(path, merge_ops(ops, [(len(suffix), "S")]))
                    for path, ops in with_prefix]

        out = []
        seen = set()
        for path, ops in full:
            ga = self._project(path, ops)
            key = (tuple(ga.node_ids), ga.path_start, ga.generate_cigar())
            if key not in seen:
                seen.add(key)
                out.append(ga)
        out.sort(key=lambda g: (tuple(g.node_ids), g.path_start,
                                g.generate_cigar()))
        return out

    def _project(self, path: Path, ops: Ops) -> GraphAlignment:
        """projectAlignmentOntoGraph: split the linear ops across the
        path's node boundaries (ref-consuming ops split; I/S stick to
        the current node)."""
        graph = self.graph
        nodes, start, end = path
        node_ids: List[int] = []
        node_ops: List[Ops] = []
        idx = 0
        offset = start  # current ref offset within nodes[idx]

        def room():
            size = len(graph.node_seq(nodes[idx]))
            limit = end + 1 if idx == len(nodes) - 1 else size
            return limit - offset

        def ensure_node():
            if not node_ids or node_ids[-1] != nodes[idx] or fresh[0]:
                node_ids.append(nodes[idx])
                node_ops.append([])
                fresh[0] = False

        fresh = [False]
        for l, t in ops:
            if t in "IS":
                ensure_node()
                node_ops[-1] = merge_ops(node_ops[-1], [(l, t)])
                continue
            while l > 0:
                if room() == 0:
                    idx += 1
                    offset = 0
                    fresh[0] = True
                take = min(l, room())
                ensure_node()
                node_ops[-1] = merge_ops(node_ops[-1], [(take, t)])
                offset += take
                l -= take
        alignments = []
        for k, (nid, nops) in enumerate(zip(node_ids, node_ops)):
            ref_start = start if k == 0 else 0
            alignments.append(NodeAlignment(ref_start, nops))
        last = alignments[-1]
        path_end = last.reference_start + last.reference_length - 1
        return GraphAlignment(node_ids, alignments, start, path_end)
