"""VCF → sequence-graph conversion.

Covers the same capability surface as the reference's python conversion
stack (``src/python/lib/grm/vcfgraph/vcfgraph.py`` records→intervals,
``graphContainer.py`` construction model, ``graphUtils.py`` passes), but
organised differently: record parsing produces a flat *allele table*
(reference-support intervals + an alt-allele catalog), a boundary sweep
segments the reference support, and graph assembly / simplification run
as explicit phases over :class:`GraphContainer`.

Output order contracts (node/edge insertion order, DFS topological
order, path enumeration order) are part of the emitted JSON — node ids
drive aligner tie-breaking — and are pinned by the golden tests
(tests/test_vcf2paragraph_golden.py), not by code structure.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..io.fasta import FastaFile
from ..io.regions import parse_region
from ..io.vcf import VcfRecord
from .model import GraphContainer


class NoVCFRecordsException(Exception):
    pass


_RC = str.maketrans("ACGTN", "TGCAN")

#: characters allowed in explicit allele sequences
_SEQ_OK = re.compile(r"^[ACGTNXacgtnx]*$")


def reverse_complement(seq: str) -> str:
    return seq.translate(_RC)[::-1]


def generate_variant_id(record: VcfRecord,
                        var_id_counts: Optional[dict] = None) -> str:
    """Stable per-record variant id: the VCF ID when present (must be
    unique), else chrom:pos with a duplicate counter suffix."""
    if record.id:
        if var_id_counts is not None:
            if record.id in var_id_counts:
                raise ValueError(f"Duplicated variant ID: {record.id}")
            var_id_counts[record.id] = 1
        return record.id
    base = f"{record.chrom}:{record.pos}"
    if var_id_counts is None:
        return base
    var_id_counts[base] = var_id_counts.get(base, 0) + 1
    return f"{base}-{var_id_counts[base]}"


def generate_allele_ids(record: VcfRecord, var_id: str):
    return [(f"{var_id}:{n}", record.alleles[n])
            for n in range(len(record.alleles))]


def _shared_prefix_len(strings) -> int:
    """Length of the common prefix of all strings."""
    strings = list(strings)
    if not strings:
        return 0
    lo = min(strings)
    hi = max(strings)
    n = 0
    for a, b in zip(lo, hi):
        if a != b:
            break
        n += 1
    return n


@dataclass
class AltAllele:
    key: str
    start: int
    end: int
    sequence: str
    haplotypes: Set[str] = field(default_factory=set)


class AlleleTable:
    """Flat allele model of one VCF window.

    Two stores: ``support`` — reference-support intervals
    ``(begin, end_exclusive, label-set)`` — and ``alts`` — an ordered
    catalog of alt alleles keyed by (span, sequence). ``cuts`` records
    positions where the reference segmentation must break even if no
    interval starts or ends there (breakpoint ends inside the window).
    """

    def __init__(self, ref_file: str, chrom: str = "chr"):
        self.fasta = FastaFile(ref_file)
        self.chrom = chrom
        self.support: List[Tuple[int, int, Set[str]]] = []
        self.alts: Dict[str, AltAllele] = {}
        self.cuts: Set[int] = set()
        self.window: Tuple[Optional[int], Optional[int]] = (None, None)

    # ------------------------------------------------------------------
    # accumulation
    # ------------------------------------------------------------------

    def add_support(self, start: int, end: int, labels=(), alleles=None):
        """Reference support for [start, end]; when the record's alleles
        share a leading padding base(s), that padding is supported
        unlabelled (it belongs to every allele equally) and only the
        distinguishing tail carries the haplotype labels."""
        pad = _shared_prefix_len(alleles) if alleles else 0
        if pad and start + pad > end + 1:
            raise ValueError(
                f"reference support [{start},{end}] shorter than the "
                "alleles' shared padding")
        if pad:
            self.support.append((start, end + 1, set()))
            if labels and start + pad <= end:
                self.support.append((start + pad, end + 1, set(labels)))
        else:
            self.support.append((start, end + 1, set(labels)))

    def add_alt(self, start: int, end: int, ref: str, alt: str,
                labels=(), ref_labels=()):
        """One alt allele vs its reference span, with shared flanking
        bases trimmed off into plain reference support. Haplotypes typed
        for a different allele of an insertion get a zero-length bypass
        allele so their path skips the insert."""
        if len(ref) != end - start + 1:
            raise ValueError(
                f"[{start},{end}]: REF length != span length")
        core_start, core_end = start, end
        while alt and ref and ref[0] == alt[0]:
            ref, alt = ref[1:], alt[1:]
            core_start += 1
        if core_start > start:
            self.add_support(start, core_start - 1)
        while alt and ref and ref[-1] == alt[-1]:
            ref, alt = ref[:-1], alt[:-1]
            core_end -= 1
        if core_end <= 0:
            raise ValueError(f"[{start},{end}]: empty trimmed ALT span")
        if core_start <= core_end < end:
            self.add_support(core_end + 1, end, labels)
        if not ref and not alt:
            raise ValueError(f"[{start},{end}]: REF equals ALT")
        self._catalog(core_start, core_end, alt, labels)
        if ref_labels and core_start > core_end:
            self._catalog(core_start, core_end, "", ref_labels)

    def _catalog(self, start: int, end: int, seq: str, labels=()):
        key = f"{start}-{end}:{seq}"
        entry = self.alts.get(key)
        if entry is None:
            entry = self.alts[key] = AltAllele(key, start, end, seq)
        entry.haplotypes.update(labels)

    # ------------------------------------------------------------------
    # record parsing
    # ------------------------------------------------------------------

    def _haplotype_alleles(self, vcf: VcfRecord, allele_graph: bool,
                           var_id: str) -> Dict[str, str]:
        """label → the allele sequence that label carries. In sample
        mode labels are sample names (via their GT); in allele-graph
        mode every allele gets its own synthetic label."""
        if allele_graph:
            return dict(generate_allele_ids(vcf, var_id))
        out = {}
        for name, vals in vcf.sample_values.items():
            gt = re.split(r"[/|]", vals.get("GT", "."))
            if "." not in gt:
                out[name] = vcf.alleles[int(gt[0])]
        return out

    def add_record(self, vcf: VcfRecord, allele_graph: bool, var_id: str,
                   ins_info_key: str):
        carriers = self._haplotype_alleles(vcf, allele_graph, var_id)
        ref_labels = {s for s, a in carriers.items() if a == vcf.ref}
        self.add_support(vcf.pos, vcf.stop, ref_labels, vcf.alleles)
        ref_seq = None
        for alt in vcf.alts or []:
            labels = {s for s, a in carriers.items() if a == alt}
            if ref_seq is None:
                ref_seq = self.fasta.fetch(
                    self.chrom, vcf.pos - 1, vcf.stop).upper()
            if alt.startswith("<"):
                self._add_symbolic(vcf, alt, ref_seq, labels, ref_labels,
                                   ins_info_key)
            else:
                if not _SEQ_OK.match(alt):
                    raise ValueError(
                        f"Illegal character in ALT allele: {alt}")
                if (len(alt[0]) > 1 or len(ref_seq) > 1) \
                        and alt[0].upper() != ref_seq[0]:
                    raise ValueError(
                        f"REF and ALT padding bases differ at "
                        f"{vcf.chrom}:{vcf.pos}")
                self.add_alt(vcf.pos, vcf.stop, ref_seq, alt, labels,
                             ref_labels)

    def _add_symbolic(self, vcf: VcfRecord, alt: str, ref_seq: str,
                      labels, ref_labels, ins_info_key: str):
        if alt == "<INS>":
            ins_seq = str(vcf.info.get(ins_info_key, "")).upper()
            if not ins_seq:
                raise ValueError(
                    f"<INS> at {self.chrom}:{vcf.pos} has no "
                    f"{ins_info_key} INFO sequence")
            if not _SEQ_OK.match(ins_seq):
                raise ValueError(
                    f"Illegal character in INS sequence: {ins_seq}")
            self.add_alt(vcf.pos, vcf.stop, ref_seq,
                         ref_seq[0] + ins_seq, labels, ref_labels)
            return
        if vcf.stop == vcf.pos:
            raise ValueError(
                f"{vcf.chrom}:{vcf.pos} symbolic non-insertion with "
                "END == POS (missing END?)")
        if alt == "<DEL>":
            self.add_alt(vcf.pos, vcf.stop, ref_seq, ref_seq[0], labels)
        elif alt == "<DUP>":
            self.add_alt(vcf.pos, vcf.pos, ref_seq[0], ref_seq, labels,
                         ref_labels)
        elif alt == "<INV>":
            if len(ref_seq) > 20000:
                # huge inversions: keep 1kb stubs of both junctions
                body = ref_seq[1:1000] + ref_seq[-1000:]
            else:
                body = ref_seq[1:]
            self.add_alt(vcf.pos, vcf.stop, ref_seq,
                         ref_seq[0] + reverse_complement(body), labels,
                         ref_labels)

    # ------------------------------------------------------------------
    # window assembly
    # ------------------------------------------------------------------

    @classmethod
    def from_records(cls, ref_file: str, records: List[VcfRecord],
                     ins_info_key: str, chrom=None, start=None, end=None,
                     padding_length: int = 150,
                     allele_graph: bool = False) -> "AlleleTable":
        table = cls(ref_file, chrom)
        id_counts: Dict[str, int] = {}
        first = last = None
        n_used = 0
        for record in records:
            if chrom is None:
                chrom = record.chrom
                table.chrom = chrom
            elif chrom != record.chrom:
                break
            if (start is not None and record.pos < start) or \
                    (end is not None and record.pos > end):
                continue
            if first is None:
                first = record.pos
            last = record.stop if last is None else max(last, record.stop)
            table.add_record(record, allele_graph,
                             generate_variant_id(record, id_counts),
                             ins_info_key)
            n_used += 1
        if not n_used:
            raise NoVCFRecordsException(
                f"No VCF records found at {chrom}:{start}-{end}")
        table.window = (first, last)
        table.add_support(first - padding_length, last + padding_length)
        for a in table.alts.values():
            if first <= a.end <= last:
                table.cuts.add(a.end + 1)
            else:
                table.add_support(a.end + 1, a.end + padding_length)
        return table

    # ------------------------------------------------------------------
    # derived views
    # ------------------------------------------------------------------

    def ref_segments(self):
        """Non-overlapping reference segments with merged label sets:
        every interval is cut at every boundary (interval starts/ends
        plus explicit cut positions inside it), then identical segments
        merge their labels. Yields (begin, end_exclusive, labels) in
        (begin, end) order."""
        bounds = sorted({b for b, _, _ in self.support}
                        | {e for _, e, _ in self.support} | self.cuts)
        pieces: Dict[Tuple[int, int], Set[str]] = {}
        for b, e, labels in self.support:
            inner = [x for x in bounds if b < x < e]
            for s, t in zip([b] + inner, inner + [e]):
                pieces.setdefault((s, t), set()).update(labels)
        for (s, t) in sorted(pieces):
            yield s, t, pieces[s, t]

    def haplotypes(self) -> Set[str]:
        out: Set[str] = set()
        for a in self.alts.values():
            out |= a.haplotypes
        for _, _, labels in self.support:
            out |= labels
        out.discard(None)
        return out

    # ------------------------------------------------------------------
    # graph assembly
    # ------------------------------------------------------------------

    def build_graph(self, allele_graph: bool = False) -> GraphContainer:
        graph = GraphContainer()
        self._chain_reference(graph)
        for a in self.alts.values():
            graph.add_alt_node(self.chrom, a.start, a.end, a.sequence,
                               a.haplotypes)
        haplos = self.haplotypes()
        self._chain_haplotypes(graph, haplos)
        self._attach_alts(graph, allele_graph)
        self._close_haplotype_edges(graph, haplos)
        return graph

    def _chain_reference(self, graph: GraphContainer):
        prev = None
        for b, e, labels in self.ref_segments():
            node = graph.add_ref_node(self.chrom, b, e - 1, labels)
            if prev is not None:
                if prev["end"] + 1 != node["start"]:
                    raise ValueError(
                        f"reference gap between {prev['name']} and "
                        f"{node['name']}")
                graph.add_edge(prev, node)
            prev = node

    def _chain_haplotypes(self, graph: GraphContainer, haplos):
        for haplo in haplos:
            prev = None
            for node in graph.nodes_by_haplo(haplo):
                if prev is not None:
                    if prev["end"] == node["start"] - 1:
                        graph.add_edge(prev, node, [haplo])
                    zero_len_ref = (prev["end"] == prev["start"] - 1
                                    and not prev["sequence"])
                    strictly_before = (prev["end"] < node["start"]
                                       and prev["start"] < node["start"])
                    if not zero_len_ref and not strictly_before:
                        raise ValueError(
                            f"haplotype {haplo} visits overlapping nodes "
                            f"{prev['name']} and {node['name']}")
                prev = node

    def _attach_alts(self, graph: GraphContainer, allele_graph: bool):
        """Wire alt nodes into the reference chain at their span
        boundaries. (The reference converter has an additional
        alt-to-following-node pass for allele graphs, vcfgraph.py:411-414,
        but it indexes its position map with a key form that never
        matches, so it contributes no edges; there is deliberately no
        counterpart here.)"""
        for node in list(graph.alt_nodes()):
            if allele_graph or not any(graph.in_edges(node)):
                graph.add_edge(
                    graph.ref_node_ending_at(node["chrom"],
                                             node["start"] - 1), node)
            if not any(graph.out_edges(node)):
                graph.add_edge(
                    node, graph.ref_node_starting_at(node["chrom"],
                                                     node["end"] + 1))

    def _close_haplotype_edges(self, graph: GraphContainer, haplos):
        """Every labelled node must be reachable by its haplotype:
        where a haplotype has no labelled way in (or out) of a node,
        label all existing in (out) edges with it."""
        for haplo in haplos:
            for node in graph.nodes_by_haplo(haplo):
                if not any(graph.in_edges(node, haplo)):
                    for e in list(graph.in_edges(node)):
                        graph.add_edge(graph.nodes[e["from"]], node,
                                       [haplo])
                if not any(graph.in_edges(node, haplo)):
                    raise ValueError(
                        f"haplotype {haplo} cannot reach {node['name']}")
                if not any(graph.out_edges(node, haplo)):
                    for e in list(graph.out_edges(node)):
                        graph.add_edge(node, graph.nodes[e["to"]],
                                       [haplo])


# ---------------------------------------------------------------------------
# graph passes
# ---------------------------------------------------------------------------

def add_source_sink(graph: GraphContainer, source_name="source",
                    sink_name="sink"):
    """Attach N-padded source/sink placeholders to every head/tail node."""
    for name in (source_name, sink_name):
        if name not in graph.nodes:
            graph.adopt_node({"name": name, "sequence": "N" * 10})
    source = graph.nodes[source_name]
    sink = graph.nodes[sink_name]
    for node in list(graph.nodes.values()):
        if node["name"] in (source_name, sink_name):
            continue
        if not any(graph.in_edges(node)):
            graph.add_edge(source, node)
        if not any(graph.out_edges(node)):
            graph.add_edge(node, sink)


def _splice(graph: GraphContainer, node: dict, head: dict, tail: dict):
    """Replace `node` by the (already inserted) head/tail pair: incoming
    edges move to head, outgoing to tail, node is removed."""
    for e in list(graph.in_edges(node)):
        graph.add_edge(graph.nodes[e["from"]], head, e["sequences"])
    for e in list(graph.out_edges(node)):
        graph.add_edge(tail, graph.nodes[e["to"]], e["sequences"])
    graph.del_node(node)


def split_ref_nodes(graph: GraphContainer, max_len=300, padding_len=150):
    """Long reference nodes keep only their two padding_len flanks (reads
    longer than the flank can't bridge the dropped middle anyway)."""
    assert max_len >= 2 * padding_len
    for node in list(graph.ref_nodes()):
        if node["end"] - node["start"] + 1 <= max_len:
            continue
        head = graph.add_ref_node(node["chrom"], node["start"],
                                  node["start"] + padding_len - 1,
                                  node["sequences"])
        tail = graph.add_ref_node(node["chrom"],
                                  node["end"] - padding_len + 1,
                                  node["end"], node["sequences"])
        _splice(graph, node, head, tail)


def split_alt_nodes(graph: GraphContainer, max_len=300, padding_len=150):
    """Same flank-only split for long alt sequence nodes."""
    assert max_len >= 2 * padding_len
    for node in list(graph.alt_nodes()):
        if len(node["sequence"]) <= max_len:
            continue
        head = graph.add_alt_node(node["chrom"], node["start"],
                                  node["end"],
                                  node["sequence"][:padding_len],
                                  node["sequences"])
        tail = graph.add_alt_node(node["chrom"], node["start"],
                                  node["end"],
                                  node["sequence"][-padding_len:],
                                  node["sequences"])
        _splice(graph, node, head, tail)


def remove_empty_nodes(graph: GraphContainer):
    """Contract zero-length nodes, rewiring each (in, out) edge pair.

    The bridging edge keeps a haplotype label when both sides carry it,
    or when one side carries it and the label has no other way through
    the removed node (it appears on no other edge of the opposite side).
    """
    for node in list(graph.nodes.values()):
        keeps_sequence = node.get("sequence", "") != ""
        is_real_ref = "reference" in node and node["start"] <= node["end"]
        if is_real_ref or keeps_sequence:
            continue
        in_labels = [s for e in graph.in_edges(node)
                     for s in e["sequences"]]
        out_labels = [s for e in graph.out_edges(node)
                      for s in e["sequences"]]
        for e_in in list(graph.in_edges(node)):
            for e_out in list(graph.out_edges(node)):
                carried = (e_in["sequences"] & e_out["sequences"]) \
                    | (e_in["sequences"] - set(out_labels)) \
                    | (e_out["sequences"] - set(in_labels))
                graph.add_edge(graph.nodes[e_in["from"]],
                               graph.nodes[e_out["to"]], carried)
        graph.del_node(node)


def combine_nodes(graph: GraphContainer):
    """Merge chain links: a node with exactly one outgoing edge to a
    node with exactly one incoming edge, genomically adjacent, same
    kind, identical label sets."""
    for first in list(graph.nodes.values()):
        if first["name"] not in graph.nodes:
            continue  # already merged away
        out = list(graph.out_edges(first))
        if len(out) != 1:
            continue
        second = graph.nodes[out[0]["to"]]
        if len(list(graph.in_edges(second))) != 1:
            continue
        if first.get("chrom") != second.get("chrom"):
            continue
        if first.get("end", -2) + 1 != second.get("start", -4):
            continue
        labels = first["sequences"]
        if second["sequences"] != labels:
            continue
        first_is_ref = "reference" in first
        if first_is_ref != ("reference" in second):
            continue
        if first_is_ref:
            merged = graph.add_ref_node(first["chrom"], first["start"],
                                        second["end"], labels)
        else:
            merged = graph.add_alt_node(
                first["chrom"], first["start"], second["end"],
                first["sequence"] + second["sequence"], labels)
        for e in list(graph.in_edges(first)):
            graph.add_edge(graph.nodes[e["from"]], merged, e["sequences"])
        for e in list(graph.out_edges(second)):
            graph.add_edge(merged, graph.nodes[e["to"]], e["sequences"])
        graph.del_node(first)
        graph.del_node(second)


def get_path(graph: GraphContainer, sequence):
    """Edge-covering walks for one haplotype label (None = all edges):
    starting from each topologically-first unvisited labelled edge,
    extend depth-first until no unvisited labelled edge continues the
    walk; every branch yields its own node-name path."""
    nodes, _ = graph.topological_sort()
    visited: Set[Tuple[str, str]] = set()

    def extend(edge, prefix):
        visited.add((edge["from"], edge["to"]))
        here = graph.nodes[edge["to"]]
        prefix = prefix + [here["name"]]
        branches = []
        for e in graph.out_edges(here, sequence):
            if (e["from"], e["to"]) not in visited:
                branches.extend(extend(e, prefix))
        return branches or [prefix]

    paths = []
    for node in nodes:
        for edge in graph.out_edges(node, sequence):
            if (edge["from"], edge["to"]) not in visited:
                paths.extend(extend(edge, [node["name"]]))
    return paths


def ref_paths(graph: GraphContainer):
    """Label genomically-adjacent ref-ref edges REF, then enumerate the
    REF-covering walks as path records."""
    for node in graph.ref_nodes():
        for edge in graph.out_edges(node):
            peer = graph.nodes[edge["to"]]
            if "reference" in peer and node["end"] + 1 == peer["start"]:
                graph.add_edge(node, peer, ["REF"])
    return [{"nodes": p, "path_id": f"REF|{i + 1}", "sequence": "REF"}
            for i, p in enumerate(get_path(graph, "REF"))]


def add_ref_path(graph: GraphContainer):
    graph.paths.extend(ref_paths(graph))


def add_alt_paths(graph: GraphContainer):
    """Every all-edge covering walk that is not a REF path becomes an
    ALT path (source/sink trimmed)."""
    ref_node_lists = [p["nodes"] for p in ref_paths(graph)]
    found = []
    for path in get_path(graph, None):
        if path and path[0] == "source":
            path = path[1:]
        if path and path[-1] == "sink":
            path = path[:-1]
        if path not in ref_node_lists:
            found.append({"nodes": path, "path_id": f"ALT|{len(found) + 1}",
                          "sequence": "ALT"})
    if found:
        graph.sequences.add("ALT")
    graph.paths.extend(found)


def add_graph(graph1: GraphContainer, graph2: GraphContainer):
    """Merge graph2 into graph1 (ref nodes first, then alts, then edges
    and paths — the insertion order downstream ids depend on)."""
    for node in graph2.ref_nodes():
        graph1.add_ref_node(node["chrom"], node["start"], node["end"],
                            node["sequences"])
    for node in graph2.alt_nodes():
        graph1.add_alt_node(node["chrom"], node["start"], node["end"],
                            node["sequence"], node["sequences"])
    for edge in graph2.iter_edges():
        graph1.add_edge(graph1.nodes[edge["from"]],
                        graph1.nodes[edge["to"]], edge["sequences"])
    graph1.paths.extend(graph2.paths)


def load_json(json_dict: dict) -> GraphContainer:
    """GraphContainer from a paragraph graph-JSON document."""
    graph = GraphContainer(json_dict["model_name"])
    for node in json_dict["nodes"]:
        labels = node.get("sequences", ())
        if "reference" in node:
            chrom, start, end = parse_region(node["reference"])
            graph.add_ref_node(chrom, start, end, labels, node["name"])
        elif "position" in node:
            chrom, start, end = parse_region(node["position"])
            graph.add_alt_node(chrom, start, end, node["sequence"],
                               labels, node["name"])
        else:
            graph.adopt_node(node)
    for edge in json_dict["edges"]:
        graph.add_edge(graph.nodes[edge["from"]], graph.nodes[edge["to"]],
                       edge.get("sequences", ()))
    graph.paths = json_dict.get("paths", [])
    graph.target_regions = json_dict.get("target_regions", [])
    graph.check()
    return graph


# ---------------------------------------------------------------------------
# conversion driver
# ---------------------------------------------------------------------------

def convert_vcf_records(records: List[VcfRecord],
                        ref: str,
                        ins_info_key: str = "SEQ",
                        target_regions=None,
                        ref_node_padding: int = 150,
                        ref_node_max_length: int = 1000,
                        allele_graph: bool = False,
                        simplify: bool = True,
                        alt_paths: bool = False,
                        alt_splitting: bool = False) -> dict:
    """One graph-JSON dict for a block of VCF records: per region,
    records → allele table → graph → simplification passes; regions
    merge into one container that then gets source/sink and paths."""
    merged = GraphContainer("Graph from VCF")
    regions = ([parse_region(r) for r in target_regions]
               if target_regions else [(None, None, None)])
    for chrom, start, end in regions:
        try:
            table = AlleleTable.from_records(
                ref, records, ins_info_key, chrom, start, end,
                ref_node_padding, allele_graph)
        except NoVCFRecordsException:
            continue
        region_graph = table.build_graph(allele_graph)
        if ref_node_max_length:
            split_ref_nodes(region_graph, ref_node_max_length,
                            ref_node_padding)
            if alt_splitting:
                split_alt_nodes(region_graph, ref_node_max_length,
                                ref_node_padding)
        if simplify:
            remove_empty_nodes(region_graph)
            combine_nodes(region_graph)
        region_graph.check()
        add_graph(merged, region_graph)

    merged.target_regions = (target_regions
                             or list(merged.get_reference_regions()))
    add_source_sink(merged)
    add_ref_path(merged)
    if alt_paths:
        add_alt_paths(merged)
    merged.check()
    return merged.json_dict()
