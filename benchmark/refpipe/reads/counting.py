"""Fragment assembly and read counting per node/edge/path family.

Equivalent of ``common::Fragment`` + ``paragraph::countReads``
(the reference's src/c++/lib/common/Fragment.cpp and
lib/paragraph/ReadCounting.cpp): reads are merged into fragments keyed by
fragment id, fragment lengths are measured both in BAM coordinates and on
the graph (via canonical coordinates), and fragments are counted against
the nodes/edges/path-family subsets their reads support.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..align.alignment import decode_read_alignment
from ..graph.coordinates import GraphCoordinates
from .read import Read, MAPPED

_U64_MAX = 2 ** 64 - 1


class Fragment:
    def __init__(self):
        self.fragment_id = ""
        self.n_reads = 0
        self.n_graph_forward_reads = 0
        self.n_graph_reverse_reads = 0
        self.bam_fragment_length = 0
        self.graph_fragment_length = 0
        self._read_positions: List[Tuple[int, int]] = []
        self._read_lengths: List[int] = []
        self.graph_nodes_supported: Set[str] = set()
        self.graph_edges_supported: Set[str] = set()
        self.graph_sequences_supported: Set[str] = set()
        self.graph_sequences_broken: Set[str] = set()

    def add_read(self, coordinates: GraphCoordinates, read: Read):
        """Fragment::addRead (Fragment.cpp:34-157)."""
        if not self.fragment_id:
            self.fragment_id = read.fragment_id
        self.n_reads += 1

        is_proper_pair = (
            read.is_mapped and read.is_mate_mapped
            and ((read.is_reverse_strand and not read.is_mate_reverse_strand)
                 or (not read.is_reverse_strand
                     and read.is_mate_reverse_strand))
            and read.mate_chrom_id == read.chrom_id)
        if not is_proper_pair or self.n_reads > 2:
            self.bam_fragment_length = _U64_MAX
        else:
            self.bam_fragment_length = (
                abs(read.mate_pos - read.pos) + len(read.bases))

        if read.graph_mapping_status == MAPPED:
            if read.is_graph_reverse_strand:
                self.n_graph_reverse_reads += 1
            else:
                self.n_graph_forward_reads += 1
            mapping = decode_read_alignment(read)
            self._read_positions.append(coordinates.canonical_start_and_end(
                mapping.node_ids, mapping.path_start, mapping.path_end))
            self._read_lengths.append(mapping.query_length)
            if len(self._read_positions) == 1:
                self.graph_fragment_length = self._read_lengths[0]
            elif len(self._read_positions) == 2:
                r1s, r1e = self._read_positions[0]
                r2s, r2e = self._read_positions[-1]
                d1 = coordinates.distance(r1e, r2s)
                d2 = coordinates.distance(r2e, r1s)
                distance = min(d1, d2)
                if distance == _U64_MAX:
                    self.graph_fragment_length = _U64_MAX
                else:
                    self.graph_fragment_length = (
                        self._read_lengths[0] + self._read_lengths[-1]
                        + distance)
            else:
                # >2 reads: chained distances by sorted start
                # (Fragment.cpp:97-138; note the reference sums
                # distance(previous, start) twice — replicated)
                has_previous = False
                previous = 0
                length = 0
                positions = sorted(self._read_positions, key=lambda p: p[0])
                for start, _end in positions:
                    if has_previous:
                        d2p = coordinates.distance(previous, start)
                        if d2p != _U64_MAX:
                            length += d2p
                        else:
                            length = _U64_MAX
                            break
                    d2e = coordinates.distance(previous, start)
                    if d2e != _U64_MAX:
                        length += d2e
                    else:
                        length = _U64_MAX
                        break
                    previous = start
                    has_previous = True
                self.graph_fragment_length = length

        self.graph_nodes_supported.update(read.graph_nodes_supported)
        self.graph_edges_supported.update(read.graph_edges_supported)
        self.graph_sequences_supported.update(read.graph_sequences_supported)
        self.graph_sequences_broken.update(read.graph_sequences_broken)


def reads_to_fragments(coordinates: GraphCoordinates,
                       reads: List[Read]) -> List[Fragment]:
    """readsToFragments (Fragment.cpp:165-181): fragments appear in order of
    first read occurrence."""
    fragment_map: Dict[str, Fragment] = {}
    out: List[Fragment] = []
    for read in reads:
        frag = fragment_map.get(read.fragment_id)
        if frag is None:
            frag = Fragment()
            fragment_map[read.fragment_id] = frag
            out.append(frag)
        frag.add_read(coordinates, read)
    return out


def _add_fragment_count(out: dict, element: str, frag: Fragment):
    """addFragmentCount (ReadCounting.cpp:52-68)."""
    if element not in out:
        out[element] = 1
        out[element + ":READS"] = frag.n_reads
        out[element + ":FWD"] = frag.n_graph_forward_reads
        out[element + ":REV"] = frag.n_graph_reverse_reads
    else:
        out[element] += 1
        out[element + ":READS"] += frag.n_reads
        out[element + ":FWD"] += frag.n_graph_forward_reads
        out[element + ":REV"] += frag.n_graph_reverse_reads


def count_nodes(fragments: List[Fragment]) -> dict:
    out: dict = {}
    for frag in fragments:
        for n in sorted(frag.graph_nodes_supported):
            _add_fragment_count(out, n, frag)
    return out


def count_edges(fragments: List[Fragment]) -> dict:
    out: dict = {}
    for frag in fragments:
        for e in sorted(frag.graph_edges_supported):
            _add_fragment_count(out, e, frag)
    return out


def count_path_families(fragments: List[Fragment], detailed: bool) -> dict:
    out: dict = {}
    for frag in fragments:
        if frag.graph_sequences_supported:
            joined = ",".join(sorted(frag.graph_sequences_supported))
            sub = out.setdefault(joined, {})
            _add_fragment_count(sub, "total", frag)
            if detailed:
                for n in sorted(frag.graph_nodes_supported):
                    _add_fragment_count(sub, n, frag)
                for e in sorted(frag.graph_edges_supported):
                    _add_fragment_count(sub, e, frag)
    return out


def fragment_statistics(fragments: List[Fragment]) -> dict:
    """alignmentStats (ReadCounting.cpp:129-223).

    Mean/variance follow boost lazy accumulators (population variance);
    median uses the same P² streaming estimator as boost's tag::median.
    """
    linear: List[float] = []
    graph: List[float] = []
    problematic_linear = 0
    problematic_graph = 0
    single = paired = multi = 0
    for f in fragments:
        if f.bam_fragment_length != _U64_MAX:
            if f.n_reads >= 2:
                linear.append(float(f.bam_fragment_length))
        else:
            problematic_linear += 1
        if f.graph_fragment_length != _U64_MAX:
            if f.n_reads >= 2:
                graph.append(float(f.graph_fragment_length))
        else:
            problematic_graph += 1
        if f.n_reads == 1:
            single += 1
        elif f.n_reads == 2:
            paired += 1
        else:
            multi += 1

    def mean(xs):
        # boost's lazy mean = sum/count is NaN for zero samples, which
        # jsoncpp serializes as null (ReadCounting.cpp:188-189)
        return sum(xs) / len(xs) if xs else None

    def variance(xs):
        if not xs:
            return 0.0
        m = mean(xs)
        return sum(x * x for x in xs) / len(xs) - m * m

    def median(xs):
        from ..utils.statistics import P2Quantile

        q = P2Quantile()
        for x in xs:
            q.add(x)
        return q.value()

    return {
        "mean_linear": mean(linear),
        "mean_graph": mean(graph),
        "median_linear": median(linear),
        "median_graph": median(graph),
        "variance_linear": variance(linear),
        "variance_graph": variance(graph),
        "single_read": single,
        "paired_read": paired,
        "multi_read": multi,
        "problematic_linear": problematic_linear,
        "problematic_graph": problematic_graph,
    }


def count_reads(coordinates: GraphCoordinates, reads: List[Read],
                output: dict, by_node: bool, by_edge: bool,
                by_path_fam: bool, path_fam_detailed: bool) -> None:
    """countReads (ReadCounting.cpp:225-245)."""
    fragments = reads_to_fragments(coordinates, reads)
    output["fragment_statistics"] = fragment_statistics(fragments)
    if by_node:
        output["read_counts_by_node"] = count_nodes(fragments)
    if by_edge:
        output["read_counts_by_edge"] = count_edges(fragments)
    if by_path_fam:
        output["read_counts_by_sequence"] = count_path_families(
            fragments, path_fam_detailed)
