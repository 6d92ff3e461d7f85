"""Validation aligner: empirical MAPQ from simulated read names.

Equivalent of ``grm::ValidationAligner``
(the reference's src/c++/lib/grm/ValidationAligner.cpp): wraps any aligner,
parses the simulated path id from the read's fragment name (everything
before the last ':'), and counts mismapped / repeat / aligned reads, from
which the empirical MAPQ table is reported (Align.cpp:42-55).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List

from ..graph.model import SequenceGraph
from ..reads.read import Read, MAPPED, BAD_ALIGN


def _cigar_nodes(cigar: str) -> str:
    """node id chain "0->2->3" from a node-CIGAR
    (ValidationAligner.cpp:96-120)."""
    nodes = re.findall(r"(\d+)\[", cigar)
    return "->".join(nodes)


class ValidationAligner:
    def __init__(self, aligner, graph: SequenceGraph, paths: List[List[int]]):
        self.aligner = aligner
        self.path_nodes: Dict[str, str] = {}
        for p in paths or []:
            path_id = "_".join(str(n) for n in p)
            self.path_nodes[path_id] = "->".join(str(n) for n in p)
        self.total = 0
        self.aligned = 0
        self.mismapped = 0
        self.repeats = 0

    @staticmethod
    def simulated_path_id(read: Read) -> str:
        """getSimulatedPathId: fragment name prefix before the last ':'."""
        return read.fragment_id.rsplit(":", 1)[0]

    def set_graph(self, graph, paths=None):
        self.aligner.set_graph(graph, paths)

    def align_read(self, read: Read, filt=None):
        self.total += 1
        self.aligner.align_read(read, filt)
        if read.graph_mapping_status == MAPPED:
            self.aligned += 1
            sim = self.simulated_path_id(read)
            cigar_nodes = _cigar_nodes(read.graph_cigar)
            sim_nodes = self.path_nodes.get(sim, "")
            if cigar_nodes not in sim_nodes:
                self.mismapped += 1
        elif (read.graph_mapping_status == BAD_ALIGN
              and not read.is_graph_alignment_unique):
            self.repeats += 1

    def report(self) -> List[str]:
        """Empirical MAPQ table lines (Align.cpp:46-55)."""
        unaligned = self.total - self.aligned - self.repeats
        if not self.mismapped:
            emp = 60
        elif self.aligned:
            emp = -10 * math.log10(self.mismapped / self.aligned)
        else:
            emp = 0
        return [
            "[VALIDATION]\tMAPQ\tEmpMAPQ\tWrong\tTotal",
            f"[VALIDATION]\tunalgnd\t0\t0\t{unaligned}",
            f"[VALIDATION]\trepeat\t0\t0\t{self.repeats}",
            f"[VALIDATION]\t60\t{emp}\t{self.mismapped}\t{self.aligned}",
        ]
