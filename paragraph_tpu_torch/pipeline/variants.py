"""On-graph small-variant discovery from read CIGARs.

Equivalent of paragraph's GraphVariants + the variant library
(the reference's src/c++/lib/paragraph/GraphVariants.cpp,
lib/variant/RefVar.cpp, lib/variant/Variant.cpp): decompose per-node
CIGARs into SNP/ins/del candidates, normalise them (right-shift /
left-shift / trim), and pile up stranded, quality-weighted depths.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..graph.coordinates import GraphCoordinates
from ..graph.model import SequenceGraph
from ..reads.read import Read


def phred_to_error_prob(ph: float) -> float:
    return 10.0 ** (ph / -10.0)


def error_prob_to_phred(p: float) -> float:
    return -10.0 * math.log10(p)


@dataclass
class RefVar:
    start: int = -1
    end: int = -1
    alt: str = ""
    flags: int = 0  # position in read (for quality extraction)

    def repr_key(self) -> str:
        return f"{self.start}-{self.end}:{self.alt}"


def cigar_to_refvar(refseq: str, altseq: str, cigar: str,
                    ref_matches: bool = True
                    ) -> Tuple[List[RefVar], int, int]:
    """cigarToRefVar (RefVar.cpp:668-777); ref_matches=True adds
    ref-matching records with "." as the alt.

    Returns (variants, ref_left, alt_left). 'N' operations raise (as the
    reference's error() does; callers skip such reads).
    """
    result: List[RefVar] = []
    refpos = 0
    altpos = 0
    for m in re.finditer(r"(\d+)([A-Z=])", cigar):
        count = int(m.group(1))
        op = m.group(2)
        if count == 0:
            raise ValueError(f"zero-length operation: {cigar}")
        if op == "S":
            altpos += count
        elif op in ("M", "=", "X"):
            ref_match_count = 0
            for _ in range(count):
                if refpos >= len(refseq) or altpos > len(altseq):
                    break
                if refseq[refpos] != altseq[altpos]:
                    if ref_match_count != 0:
                        result.append(RefVar(refpos - ref_match_count,
                                             refpos - 1, ".",
                                             altpos - ref_match_count))
                        ref_match_count = 0
                    result.append(RefVar(refpos, refpos, altseq[altpos],
                                         altpos))
                elif ref_matches:
                    ref_match_count += 1
                refpos += 1
                altpos += 1
            if ref_match_count != 0:
                result.append(RefVar(refpos - ref_match_count, refpos - 1,
                                     ".", altpos - ref_match_count))
        elif op == "I":
            result.append(RefVar(refpos, refpos - 1,
                                 altseq[altpos:altpos + count], altpos))
            altpos += count
        elif op == "D":
            result.append(RefVar(refpos, refpos + count - 1, "", altpos))
            refpos += count
        else:
            raise ValueError(f"Unknown CIGAR operation: {op}")
    return result, len(refseq) - refpos, len(altseq) - altpos


def _trim_left(ref: str, rv: RefVar, refpadding: bool = False):
    """trimLeft(ref substring, rv) (RefVar.cpp:46-59)."""
    ref_min = 1 if refpadding else 0
    rel_start = 0
    while (len(ref) - rel_start > ref_min
           and len(rv.alt) - rel_start > ref_min
           and rel_start < len(ref) and rel_start < len(rv.alt)
           and ref[rel_start] == rv.alt[rel_start]):
        rel_start += 1
        rv.start += 1
    if rel_start > 0:
        rv.alt = rv.alt[rel_start:]


def _trim_right(ref: str, rv: RefVar, refpadding: bool = False):
    """trimRight (RefVar.cpp:62-91)."""
    reflen = rv.end - rv.start + 1
    altlen = len(rv.alt)
    min_len = 1 if refpadding else 0
    if reflen <= min_len or altlen <= min_len:
        return
    while (reflen > min_len and altlen > min_len
           and reflen - 1 < len(ref)
           and ref[reflen - 1] == rv.alt[altlen - 1]):
        altlen -= 1
        reflen -= 1
    rv.end = rv.start + reflen - 1
    rv.alt = rv.alt[:altlen] if altlen > 0 else ""


def _span(ref: str, rv: RefVar) -> str:
    return ref[rv.start:rv.end + 1]


def left_shift(ref: str, rv: RefVar, pos_min: int):
    """leftShift (RefVar.cpp:108-166); trims keep the VCF padding base
    (refpadding defaults to true, RefVar.hh:136-138)."""
    pos_min = max(pos_min, 0)
    _trim_left(_span(ref, rv), rv, True)
    _trim_right(_span(ref, rv), rv, True)
    reflen = rv.end - rv.start + 1
    if reflen < 0 and not rv.alt:
        return
    if reflen >= 0 and reflen == len(rv.alt):
        if _span(ref, rv) == rv.alt:
            return
    done = False
    while not done:
        done = True
        reflen = rv.end - rv.start + 1
        if rv.start <= pos_min:
            break
        if (rv.start < 1 or not ref or len(ref) < rv.start + reflen
                or ref[rv.start - 1] == "N"):
            break
        if reflen > 0 and rv.alt and ref[rv.start + reflen - 1] == rv.alt[-1]:
            reflen -= 1
            rv.end -= 1
            rv.alt = rv.alt[:-1]
            done = False
        if reflen == 0 or not rv.alt:
            rv.start -= 1
            rv.alt = ref[rv.start] + rv.alt
            done = False
    _trim_left(_span(ref, rv), rv, True)
    _trim_right(_span(ref, rv), rv, True)


def right_shift(ref: str, rv: RefVar, pos_max: Optional[int] = None):
    """rightShift (RefVar.cpp:169-227)."""
    if pos_max is None:
        pos_max = 2 ** 62
    _trim_left(_span(ref, rv), rv, True)
    _trim_right(_span(ref, rv), rv, True)
    reflen = rv.end - rv.start + 1
    if reflen < 0 and not rv.alt:
        return
    if reflen >= 0 and reflen == len(rv.alt):
        if _span(ref, rv) == rv.alt:
            return
    done = False
    while not done:
        done = True
        reflen = rv.end - rv.start + 1
        if rv.end >= pos_max:
            break
        if (not ref or len(ref) <= rv.start + reflen
                or ref[rv.start + reflen] == "N"):
            break
        if reflen > 0 and rv.alt and ref[rv.start] == rv.alt[0]:
            reflen -= 1
            rv.start += 1
            rv.alt = rv.alt[1:]
            done = False
        if reflen == 0 or not rv.alt:
            refnext = rv.start + reflen
            rv.end += 1
            rv.alt = rv.alt + ref[refnext:refnext + 1]
            done = False
    _trim_left(_span(ref, rv), rv, True)
    _trim_right(_span(ref, rv), rv, True)


class PileupData:
    __slots__ = ("stranded_DP", "qual_weighted_DP")

    def __init__(self):
        self.stranded_DP = [0, 0]
        self.qual_weighted_DP = [0.0, 0.0]

    def add_obs(self, is_rev: bool = False, pqual: int = 60):
        i = 1 if is_rev else 0
        self.stranded_DP[i] += 1
        self.qual_weighted_DP[i] += 1.0 - phred_to_error_prob(pqual)

    def iadd(self, rhs: "PileupData"):
        for i in range(2):
            self.stranded_DP[i] += rhs.stranded_DP[i]
            self.qual_weighted_DP[i] += rhs.qual_weighted_DP[i]

    def isub(self, rhs: "PileupData"):
        for i in range(2):
            self.stranded_DP[i] = max(
                0, self.stranded_DP[i] - rhs.stranded_DP[i])
            self.qual_weighted_DP[i] = max(
                0.0, self.qual_weighted_DP[i] - rhs.qual_weighted_DP[i])

    def idiv(self, val: float):
        for i in range(2):
            self.stranded_DP[i] = int(self.stranded_DP[i] / val)
            self.qual_weighted_DP[i] /= val


@dataclass
class Variant:
    start: int = 0
    end: int = 0
    alt: str = ""
    leftmost: int = 0
    rightmost: int = 0
    adr_forward: int = 0
    adr_backward: int = 0
    ada_forward: int = 0
    ada_backward: int = 0
    ado_forward: int = 0
    ado_backward: int = 0
    wadr_forward: float = 0.0
    wadr_backward: float = 0.0
    wada_forward: float = 0.0
    wada_backward: float = 0.0
    wado_forward: float = 0.0
    wado_backward: float = 0.0

    def to_json(self) -> dict:
        """Variant::toJson (Variant.hh:146-200): zero-valued fields are
        omitted like the reference's if(x) guards."""
        val = {}
        if self.start:
            val["start"] = self.start
        if self.end:
            val["end"] = self.end
        if self.leftmost:
            val["leftmost"] = self.leftmost
        if self.rightmost:
            val["rightmost"] = self.rightmost
        if self.alt:
            val["alt"] = self.alt
        if self.adr_forward:
            val["adrForward"] = self.adr_forward
        if self.adr_backward:
            val["adrBackward"] = self.adr_backward
        if self.ada_forward:
            val["adaForward"] = self.ada_forward
        if self.ada_backward:
            val["adaBackward"] = self.ada_backward
        if self.ado_forward:
            val["adoForward"] = self.ado_forward
        if self.ado_backward:
            val["adoBackward"] = self.ado_backward
        if self.wadr_forward:
            val["wadrForward"] = self.wadr_forward
        if self.wadr_backward:
            val["wadrBackward"] = self.wadr_backward
        if self.wada_forward:
            val["wadaForward"] = self.wada_forward
        if self.wada_backward:
            val["wadaBackward"] = self.wada_backward
        if self.wado_forward:
            val["wadoForward"] = self.wado_forward
        if self.wado_backward:
            val["wadoBackward"] = self.wado_backward
        return val


class VariantCandidateList:
    """variant::VariantCandidateList (Variant.cpp:41-255)."""

    def __init__(self, reference: str):
        self.reference = reference
        self.reference_pileups = [PileupData() for _ in reference]
        self.nonreference_pileups = [PileupData() for _ in reference]
        self.variants: Dict[str, Variant] = {}
        self.variant_pileups: Dict[str, PileupData] = {}

    def add_refvar_observation(self, rv: RefVar, is_rev: bool,
                               left_boundary: int, pqual: int) -> int:
        if rv.end >= rv.start and rv.alt == ".":
            for pos in range(rv.start,
                             min(len(self.reference), rv.end + 1)):
                self.reference_pileups[pos].add_obs(is_rev, pqual)
            return rv.end
        rightmost = max(rv.start, rv.end)
        if rv.alt != ".":
            right_shift(self.reference, rv)
            rightmost = max(rv.start, rv.end)
            left_shift(self.reference, rv, left_boundary)
            _trim_left(self.reference[rv.start:rv.end + 1], rv, False)
            for pos in range(rv.start,
                             min(len(self.reference), rightmost + 1)):
                self.nonreference_pileups[pos].add_obs(is_rev, pqual)
            key = rv.repr_key()
            if key not in self.variants:
                self.variants[key] = Variant(
                    start=rv.start, end=rv.end, alt=rv.alt,
                    leftmost=rv.start, rightmost=rightmost)
            self.variant_pileups.setdefault(key, PileupData()).add_obs(
                is_rev, pqual)
        return rightmost

    def get_variants(self) -> List[Variant]:
        result = []
        for key in sorted(self.variants):  # std::map order
            v = self.variants[key]
            pile = self.variant_pileups.get(key)
            if pile is not None:
                ref_pile = PileupData()
                other_pile = PileupData()
                start_pos = v.leftmost
                end_pos = v.rightmost
                if end_pos < start_pos:
                    start_pos, end_pos = end_pos, start_pos
                start_pos = max(0, start_pos)
                for pos in range(start_pos, end_pos + 1):
                    if pos >= len(self.reference):
                        break
                    ref_pile.iadd(self.reference_pileups[pos])
                    other_pile.iadd(self.nonreference_pileups[pos])
                reflen = end_pos - start_pos + 1
                if reflen > 1:
                    ref_pile.idiv(reflen)
                    other_pile.idiv(reflen)
                other_pile.isub(pile)
                v.adr_forward = ref_pile.stranded_DP[0]
                v.adr_backward = ref_pile.stranded_DP[1]
                v.wadr_forward = ref_pile.qual_weighted_DP[0]
                v.wadr_backward = ref_pile.qual_weighted_DP[1]
                v.ado_forward = other_pile.stranded_DP[0]
                v.ado_backward = other_pile.stranded_DP[1]
                v.wado_forward = other_pile.qual_weighted_DP[0]
                v.wado_backward = other_pile.qual_weighted_DP[1]
                v.ada_forward = pile.stranded_DP[0]
                v.ada_backward = pile.stranded_DP[1]
                v.wada_forward = pile.qual_weighted_DP[0]
                v.wada_backward = pile.qual_weighted_DP[1]
            result.append(v)
        return result

    def append_coverage(self, coords: GraphCoordinates, node_name: str,
                        coverage: dict):
        """appendCoverage (Variant.cpp:236-293)."""
        fields = ["cpos", "node", "offset", "base", "ref", "ref:FWD",
                  "ref:REV", "other", "other:FWD", "other:REV", "wref",
                  "wref:FWD", "wref:REV", "wother", "wother:FWD",
                  "wother:REV"]
        for f in fields:
            coverage.setdefault(f, [])
        node_start = coords.canonical_pos(node_name)
        for pos in range(len(self.reference)):
            rp = self.reference_pileups[pos]
            op = self.nonreference_pileups[pos]
            coverage["cpos"].append(node_start + pos)
            coverage["node"].append(node_name)
            coverage["offset"].append(pos)
            coverage["base"].append(self.reference[pos])
            coverage["ref"].append(rp.stranded_DP[0] + rp.stranded_DP[1])
            coverage["ref:FWD"].append(rp.stranded_DP[0])
            coverage["ref:REV"].append(rp.stranded_DP[1])
            coverage["other"].append(op.stranded_DP[0] + op.stranded_DP[1])
            coverage["other:FWD"].append(op.stranded_DP[0])
            coverage["other:REV"].append(op.stranded_DP[1])
            coverage["wref"].append(
                rp.qual_weighted_DP[0] + rp.qual_weighted_DP[1])
            coverage["wref:FWD"].append(rp.qual_weighted_DP[0])
            coverage["wref:REV"].append(rp.qual_weighted_DP[1])
            coverage["wother"].append(
                op.qual_weighted_DP[0] + op.qual_weighted_DP[1])
            coverage["wother:FWD"].append(op.qual_weighted_DP[0])
            coverage["wother:REV"].append(op.qual_weighted_DP[1])


def _update_candidate_lists(graph: SequenceGraph, read: Read,
                            target: Dict[int, VariantCandidateList]):
    """updateVariantCandidateLists (GraphVariants.cpp:69-161)."""
    graph_cigar = read.graph_cigar
    pos_in_node = read.graph_pos
    remaining_read = read.bases
    for m in re.finditer(r"(\d+)\[([^\]]*)\]", graph_cigar):
        node_id = int(m.group(1))
        node_cigar = m.group(2)
        node_seq = graph.node_seq(node_id)
        vars_this_node, _ref_left, alt_left = cigar_to_refvar(
            node_seq[pos_in_node:], remaining_read, node_cigar)
        remaining_read = remaining_read[len(remaining_read) - alt_left:]
        vcl = target.get(node_id)
        if vcl is None:
            vcl = VariantCandidateList(node_seq)
            target[node_id] = vcl
        last_end = -1
        for var in vars_this_node:
            var.start += pos_in_node
            var.end += pos_in_node
            mean_qual = 0
            if 0 <= var.flags < len(read.bases):
                if var.alt:
                    qual_substr = read.quals[var.flags:
                                             var.flags + len(var.alt)]
                else:
                    vstart = max(0, var.flags - 1)
                    vend = max(0, var.flags)
                    qual_substr = read.quals[vstart:vend + 1]
                fqual = 0.0
                for x in qual_substr:
                    fqual += phred_to_error_prob(ord(x) - 33)
                if len(qual_substr) > 1:
                    fqual /= len(qual_substr)
                mean_qual = int(error_prob_to_phred(fqual)) if fqual > 0 \
                    else 0
            last_end = max(last_end, vcl.add_refvar_observation(
                var, read.is_graph_reverse_strand, last_end, mean_qual))
        pos_in_node = 0


def get_variants(coordinates: GraphCoordinates, reads: List[Read],
                 output: dict, min_reads_for_variant: int,
                 min_frac_for_variant: float, paths, write_variants: bool,
                 write_node_coverage: bool, write_path_coverage: bool):
    """getVariants (GraphVariants.cpp:175-291)."""
    graph = coordinates.graph
    candidates: Dict[int, VariantCandidateList] = {}
    candidates_by_sequence: Dict[str, Dict[int, VariantCandidateList]] = {}
    for r in reads:
        try:
            if write_variants or write_node_coverage:
                _update_candidate_lists(graph, r, candidates)
            if write_path_coverage:
                for seq in r.graph_sequences_supported:
                    target = candidates_by_sequence.setdefault(seq, {})
                    _update_candidate_lists(graph, r, target)
        except (ValueError, IndexError):
            pass  # reference logs a warning and skips the read

    if write_variants:
        out_v: dict = {}
        output["variants"] = out_v
        for node_id in sorted(candidates):
            node_name = graph.node_name(node_id)
            arr = []
            out_v[node_name] = arr
            for variant in candidates[node_id].get_variants():
                alt_count = variant.ada_backward + variant.ada_forward
                total_count = (variant.adr_backward + variant.adr_forward
                               + variant.ada_backward + variant.ada_forward
                               + variant.ado_backward + variant.ado_forward)
                if (alt_count < min_reads_for_variant
                        or (total_count
                            and alt_count / total_count
                            < min_frac_for_variant)):
                    continue
                arr.append(variant.to_json())
    if write_node_coverage:
        out_nc: dict = {}
        output["node_coverage"] = out_nc
        for node_id in sorted(candidates):
            node_name = graph.node_name(node_id)
            out_nc[node_name] = {}
            candidates[node_id].append_coverage(
                coordinates, node_name, out_nc[node_name])
    if write_path_coverage:
        out_pc: dict = {}
        output["path_coverage"] = out_pc
        for p in paths or []:
            path_id = p["path_id"]
            sequence_id = p["sequence"]
            seq_cands = candidates_by_sequence.get(sequence_id)
            out_pc[path_id] = {}
            for node_name in p["nodes"]:
                node_id = graph.name_to_id[node_name]
                if seq_cands is None or node_id not in seq_cands:
                    vcl = VariantCandidateList(graph.node_seq(node_id))
                    vcl.append_coverage(coordinates, node_name,
                                        out_pc[path_id])
                else:
                    seq_cands[node_id].append_coverage(
                        coordinates, node_name, out_pc[path_id])