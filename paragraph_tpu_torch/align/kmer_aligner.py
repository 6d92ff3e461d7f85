"""Gapless positional-kmer aligner against enumerated path sequences.

Equivalent of ``grm::KmerAligner<16>``
(the reference's src/c++/lib/grm/KmerAligner.cpp): kmer position matching
between read and path sequences proposes gapless offsets; candidates are
scored by mismatch count (best must have <= 2), N bases at the ends are
soft-clipped, and equal-scoring alignments with different placements make
the read non-unique.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..graph.model import SequenceGraph
from ..reads.read import Read, MAPPED, UNMAPPED, BAD_ALIGN
from .graph_aligner import reverse_complement

KMER_LENGTH = 16


@dataclass
class _Path:
    path_id: int
    node_ids: List[int]
    seq: str
    starts: List[Tuple[int, int]]  # (offset in path seq, node id)
    kmer_positions: Dict[str, List[int]]


@dataclass
class _Candidate:
    path_id: int
    position: int
    reverse: bool
    mismatches: int


class KmerAligner:
    def __init__(self, kmer_length: int = KMER_LENGTH):
        self.k = kmer_length
        self.graph: Optional[SequenceGraph] = None
        self.paths: List[_Path] = []
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
            kp: Dict[str, List[int]] = {}
            for i in range(len(seq) - self.k + 1):
                kp.setdefault(seq[i:i + self.k], []).append(i)
            self.paths.append(_Path(pid, list(node_ids), seq, starts, kp))

    def _candidates_for(self, bases: str, path: _Path, reverse: bool,
                        out: List[_Candidate]):
        offsets = set()
        for pos in range(len(bases) - self.k + 1):
            kmer = bases[pos:pos + self.k]
            for ppos in path.kmer_positions.get(kmer, ()):
                offset = ppos - pos
                if 0 <= offset and len(path.seq) >= offset + len(bases):
                    offsets.add(offset)
        for offset in sorted(offsets):
            ref = path.seq[offset:offset + len(bases)]
            mismatches = sum(
                1 for a, b in zip(bases, ref)
                if a != b and a != "N" and b != "N")
            out.append(_Candidate(path.path_id, offset, reverse, mismatches))

    def align_read(self, read: Read) -> None:
        """KmerAligner::alignRead (KmerAligner.cpp:519-538)."""
        self.attempted += 1
        read.graph_mapping_status = UNMAPPED
        bases = read.bases
        rv_bases = reverse_complement(bases)
        candidates: List[_Candidate] = []
        for path in self.paths:
            self._candidates_for(bases, path, False, candidates)
            self._candidates_for(rv_bases, path, True, candidates)
        if not candidates:
            return
        best = min(candidates, key=lambda c: c.mismatches)
        if best.mismatches > 2:
            return
        self._update_alignment(best, bases, rv_bases, read)
        for c in candidates:
            if c is best or c.mismatches != best.mismatches:
                continue
            other = Read(bases=bases)
            self._update_alignment(c, bases, rv_bases, other)
            if (other.graph_cigar != read.graph_cigar
                    or other.graph_pos != read.graph_pos):
                read.graph_mapq = 0
                read.is_graph_alignment_unique = False
                read.graph_mapping_status = BAD_ALIGN
                break
        if read.graph_mapping_status == MAPPED:
            self.mapped += 1

    def _update_alignment(self, cand: _Candidate, bases: str,
                          rv_bases: str, read: Read):
        """updateAlignment + buildCigar (KmerAligner.cpp:424-470)."""
        path = self.paths[cand.path_id]
        seq = rv_bases if cand.reverse else bases
        pos = cand.position
        ref = path.seq
        # soft clip N overhangs at either end
        left_clip = 0
        while (left_clip < len(seq)
               and ref[pos + left_clip] == "N"):
            left_clip += 1
        right_clip = 0
        while (right_clip < len(seq) - left_clip
               and ref[pos + len(seq) - 1 - right_clip] == "N"):
            right_clip += 1
        pos += left_clip
        length = len(seq) - left_clip - right_clip

        # locate start node
        start_idx = 0
        for i, (off, _nid) in enumerate(path.starts):
            if off <= pos:
                start_idx = i
            else:
                break
        cigar = ""
        score = 0
        this_start = pos - path.starts[start_idx][0]
        seq_pos = left_clip
        length_left = length
        start_pos_in_node = this_start
        first = True
        while start_idx < len(path.starts) and length_left > 0:
            off, nid = path.starts[start_idx]
            if start_idx + 1 < len(path.starts):
                this_length = min(
                    length_left,
                    path.starts[start_idx + 1][0] - off - this_start)
            else:
                this_length = length_left
            if this_length > 0:
                ops = ""
                last_op = ""
                run = 0
                for i in range(this_length):
                    rc = ref[off + this_start + i]
                    qc = seq[seq_pos + i]
                    op = ("M" if rc == qc else
                          "N" if (rc == "N" or qc == "N") else "X")
                    if op != last_op:
                        if run:
                            ops += f"{run}{last_op}"
                            if last_op == "M":
                                score += run
                        last_op = op
                        run = 0
                    run += 1
                if run:
                    ops += f"{run}{last_op}"
                    if last_op == "M":
                        score += run
                node_cigar = f"{nid}["
                if first and left_clip:
                    node_cigar += f"{left_clip}S"
                node_cigar += ops
                if right_clip and this_length == length_left:
                    node_cigar += f"{right_clip}S"
                node_cigar += "]"
                cigar += node_cigar
                first = False
                seq_pos += this_length
            length_left -= this_length
            start_idx += 1
            this_start = 0

        read.graph_pos = start_pos_in_node
        if cand.reverse:
            read.bases = rv_bases
            read.is_graph_reverse_strand = not read.is_reverse_strand
        else:
            read.is_graph_reverse_strand = read.is_reverse_strand
        read.graph_cigar = cigar
        read.graph_alignment_score = score
        read.graph_mapq = 60
        read.is_graph_alignment_unique = True
        read.graph_mapping_status = MAPPED
