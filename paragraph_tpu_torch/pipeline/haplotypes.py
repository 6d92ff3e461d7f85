"""Read-backed haplotype / phasing evidence.

Equivalent of paragraph's HaplotypePaths
(the reference's src/c++/lib/paragraph/HaplotypePaths.cpp) plus the
graph-tools path operations it uses (mergePaths / greedyMerge /
getPathSegmentsForFamily, graph-tools src/graphcore/PathOperations.cpp and
PathFamilyOperations.cpp): fragment alignment paths are merged, converted
to edge families, aggregated with fragment counts ("phasing"), and merged
into detected haplotype path groups ("phased_path_groups").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..align.alignment import decode_graph_alignment
from ..graph.coordinates import GraphCoordinates
from ..graph.model import SequenceGraph
from ..reads.read import Read

_U64_MAX = 2 ** 64 - 1


class LitePath:
    """Path = (node id list, start offset, end offset)."""

    __slots__ = ("nodes", "start", "end")

    def __init__(self, nodes: List[int], start: int, end: int):
        self.nodes = list(nodes)
        self.start = start
        self.end = end

    def length(self, graph: SequenceGraph) -> int:
        if len(self.nodes) == 1:
            return self.end - self.start + 1
        total = len(graph.node_seq(self.nodes[0])) - self.start
        for nid in self.nodes[1:-1]:
            total += len(graph.node_seq(nid))
        return total + self.end + 1

    def encode(self, graph: SequenceGraph) -> str:
        """graph-tools Path::encode: "(start-node)-(nodes)-(node-end)"."""
        pieces = []
        for i, nid in enumerate(self.nodes):
            name = graph.node_name(nid)
            if len(self.nodes) == 1:
                pieces.append(f"({self.start}-{name}-{self.end})")
            elif i == 0:
                pieces.append(f"({self.start}-{name})")
            elif i == len(self.nodes) - 1:
                pieces.append(f"({name}-{self.end})")
            else:
                pieces.append(f"({name})")
        return "".join(pieces)


def check_prefix_suffix_overlap(p1: LitePath, p2: LitePath) -> bool:
    """checkPathPrefixSuffixOverlap (PathOperations.cpp:340-430)."""
    if not p1.nodes or not p2.nodes:
        return False
    if p1.nodes[-1] < p2.nodes[0] or p1.nodes[0] > p2.nodes[-1]:
        return False
    i1 = 0
    i2 = 0
    shared = 0
    while i1 < len(p1.nodes) and i2 < len(p2.nodes):
        if p1.nodes[i1] < p2.nodes[i2]:
            if i2 != 0:
                return False
            i1 += 1
        elif p1.nodes[i1] > p2.nodes[i2]:
            if i1 != 0:
                return False
            i2 += 1
        else:
            shared += 1
            i1 += 1
            i2 += 1
    if shared == 0:
        return False
    if shared == 1:
        # single shared node: the paths must also overlap in offsets there
        # (PathOperations.cpp:393-446)
        if i1 == len(p1.nodes) and i2 == len(p2.nodes):
            if len(p1.nodes) == 1 and len(p2.nodes) > 1:
                if p2.end < p1.start:
                    return False
            elif len(p1.nodes) > 1 and len(p2.nodes) == 1:
                if p1.end < p2.start:
                    return False
            elif len(p1.nodes) == 1 and len(p2.nodes) == 1:
                return p1.end >= p2.start and p2.end >= p1.start
        elif i1 < len(p1.nodes):
            if p2.end < p1.start:
                return False
        else:
            if p1.end < p2.start:
                return False
    return True


def check_paths_adjacent(graph: SequenceGraph, p1: LitePath,
                         p2: LitePath) -> bool:
    """checkIfPathsAdjacent (PathOperations.cpp:300-335)."""
    if p1.nodes[-1] > p2.nodes[0]:
        return check_paths_adjacent(graph, p2, p1)
    e1, s2 = p1.nodes[-1], p2.nodes[0]
    if e1 != s2 and not graph.has_edge(e1, s2):
        return False
    if e1 != s2:
        return (p2.start == 0
                and p1.end == len(graph.node_seq(e1)) - 1)
    return p1.end + 1 == p2.start


def merge_paths(p1: LitePath, p2: LitePath) -> LitePath:
    """mergePaths (PathOperations.cpp:459-516)."""
    start = -1
    end = -1
    nodes: List[int] = []
    i1 = 0
    i2 = 0
    while i1 < len(p1.nodes) and i2 < len(p2.nodes):
        if p1.nodes[i1] < p2.nodes[i2]:
            if start < 0:
                start = p1.start
            nodes.append(p1.nodes[i1])
            i1 += 1
        elif p1.nodes[i1] > p2.nodes[i2]:
            if start < 0:
                start = p2.start
            nodes.append(p2.nodes[i2])
            i2 += 1
        else:
            if start < 0:
                start = min(p1.start, p2.start)
            nodes.append(p1.nodes[i1])
            i1 += 1
            i2 += 1
    if i1 == len(p1.nodes) and i2 == len(p2.nodes):
        end = max(p1.end, p2.end)
    elif i1 < len(p1.nodes):
        nodes.extend(p1.nodes[i1:])
        end = p1.end
    else:
        nodes.extend(p2.nodes[i2:])
        end = p2.end
    assert start >= 0 and end >= 0
    return LitePath(nodes, start, end)


def greedy_merge(paths: List[LitePath]) -> None:
    """greedyMerge (PathOperations.cpp:524-554); in place."""
    has_merged = True
    while has_merged and len(paths) > 1:
        has_merged = False
        for a in range(len(paths)):
            for b in range(a + 1, len(paths)):
                if check_prefix_suffix_overlap(paths[a], paths[b]):
                    merged = merge_paths(paths[a], paths[b])
                    pb = paths.pop(b)
                    paths.pop(a)
                    paths.append(merged)
                    has_merged = True
                    break
            if has_merged:
                break


def exhaustive_merge(graph: SequenceGraph,
                     paths: List[LitePath]) -> List[LitePath]:
    """exhaustiveMerge (PathOperations.cpp:564-626); in place.

    Unlike greedy_merge, every overlapping pair yields its merge while
    BOTH originals stay in the pool (unless one contains the other), so
    all combinations of left/right extensions materialise — converging
    when a full pass produces no new merge. Containment is detected by
    encode() equality, exactly like the reference."""
    has_merged = True
    while has_merged and len(paths) > 1:
        has_merged = False
        new_paths: List[LitePath] = []
        for ai, a in enumerate(paths):
            for bi, b in enumerate(paths):
                if bi == ai:
                    continue
                if check_prefix_suffix_overlap(a, b):
                    merged = merge_paths(a, b)
                    a_in_b = merged.encode(graph) == b.encode(graph)
                    b_in_a = merged.encode(graph) == a.encode(graph)
                    if a_in_b and b_in_a:
                        new_paths.append(b)
                    elif a_in_b or b_in_a:
                        new_paths.append(merged)
                    else:
                        new_paths.extend((merged, a, b))
                    has_merged = True
                else:
                    new_paths.append(b)
            if has_merged:
                break
            new_paths.append(a)
        if has_merged:
            paths[:] = new_paths
    return paths


def intersect_paths(graph: SequenceGraph, p1: LitePath,
                    p2: LitePath) -> List[LitePath]:
    """intersectPaths (PathOperations.cpp:628-720): maximal sub-paths
    covered by BOTH paths, walking the two sorted node lists in lock
    step and clipping each shared node to the offset overlap. A match
    that starts mid-node, follows a non-edge, or ends mid-node closes
    the current piece."""
    result: List[LitePath] = []
    nodes: List[int] = []
    start = end = -1

    def flush():
        nonlocal nodes, start, end
        if nodes:
            result.append(LitePath(nodes, start, end))
            nodes = []
            start = end = -1

    i1 = i2 = 0
    n1, n2 = p1.nodes, p2.nodes
    while i1 < len(n1) and i2 < len(n2):
        if n1[i1] < n2[i2]:
            flush()
            i1 += 1
        elif n1[i1] > n2[i2]:
            flush()
            i2 += 1
        else:
            node = n1[i1]
            size = len(graph.node_seq(node))
            s1 = p1.start if i1 == 0 else 0
            s2 = p2.start if i2 == 0 else 0
            e1 = p1.end if i1 == len(n1) - 1 else size - 1
            e2 = p2.end if i2 == len(n2) - 1 else size - 1
            s = max(s1, s2)
            e = min(e1, e2)
            if s <= e:
                if s > 0:
                    flush()
                if not nodes:
                    start = s
                elif not graph.has_edge(nodes[-1], node):
                    flush()
                    start = s
                end = e
                nodes.append(node)
                if e + 1 < size:
                    flush()
            elif nodes:
                flush()
            i1 += 1
            i2 += 1
    flush()
    return result


def path_contains(edges: Set[Tuple[int, int]], out_nodes: Set[int],
                  in_nodes: Set[int], nodes: List[int]) -> bool:
    """PathFamily::containsPath (graph-tools PathFamily.cpp:89-107)."""
    matched = 0
    for a, b in zip(nodes, nodes[1:]):
        if (a, b) in edges:
            matched += 1
        elif a in out_nodes or b in in_nodes:
            return False
    return matched > 0


def get_path_segments_for_family(graph: SequenceGraph,
                                 edges: List[Tuple[int, int]]
                                 ) -> List[LitePath]:
    """getPathSegmentsForFamily (PathFamilyOperations.cpp:46-92)."""
    segments: List[LitePath] = []
    edges = sorted(edges)
    in_count: Dict[int, int] = {}
    out_count: Dict[int, int] = {}
    for f, t in edges:
        out_count[f] = out_count.get(f, 0) + 1
        in_count[t] = in_count.get(t, 0) + 1
    for f, t in edges:
        if f == t:
            continue
        extended = False
        for prefix in segments:
            if (prefix.nodes[-1] == f and in_count.get(f, 0) == 1
                    and out_count.get(f, 0) == 1):
                prefix.nodes.append(t)
                prefix.end = len(graph.node_seq(t)) - 1
                extended = True
        if not extended:
            segments.append(LitePath(
                [f, t], 0, len(graph.node_seq(t)) - 1))
    return segments


def get_fragment_paths(graph: SequenceGraph, reads: List[Read]
                       ) -> Dict[str, List[LitePath]]:
    """getFragmentPaths (HaplotypePaths.cpp:80-98)."""
    path_map: Dict[str, List[LitePath]] = {}
    for read in reads:
        try:
            gm = decode_graph_alignment(read.graph_pos, read.graph_cigar)
        except ValueError:
            continue
        if gm.node_ids:
            path_map.setdefault(read.fragment_id, []).append(
                LitePath(gm.node_ids, gm.path_start, gm.path_end))
    for paths in path_map.values():
        greedy_merge(paths)
    return dict(sorted(path_map.items()))


def get_phasing_families(graph: SequenceGraph, reads: List[Read]):
    """getPhasingFamilies (HaplotypePaths.cpp:124-182): returns list of
    (sorted_edge_list, count)."""
    coords = GraphCoordinates(graph)
    fams: Dict[Tuple[Tuple[int, int], ...], int] = {}
    for _fragment, paths in get_fragment_paths(graph, reads).items():
        edges: Set[Tuple[int, int]] = set()
        for p in paths:
            for a, b in zip(p.nodes, p.nodes[1:]):
                edges.add((a, b))
        if not edges:
            continue
        sorted_edges = tuple(sorted(edges))
        prev = None
        is_linear = True
        for edge in sorted_edges:
            if prev is not None:
                d = coords.distance(
                    coords.canonical_pos(graph.node_name(prev), 0),
                    coords.canonical_pos(graph.node_name(edge[0]), 0))
                if d == _U64_MAX:
                    is_linear = False
            prev = edge[1]
        if not is_linear:
            continue
        fams[sorted_edges] = fams.get(sorted_edges, 0) + 1
    return sorted(fams.items())


def add_haplotype_paths(reads: List[Read], graph: SequenceGraph,
                        paths_json: list, output: dict) -> None:
    """addHaplotypePaths (HaplotypePaths.cpp:184-406)."""
    families = get_phasing_families(graph, reads)
    phasing = []
    uber_edges: Set[Tuple[int, int]] = set()
    for edges, count in families:
        phasing.append({
            "edges": [
                {"from": graph.node_name(f), "to": graph.node_name(t)}
                for f, t in edges
            ],
            "count": count,
        })
        uber_edges.update(edges)
    output["phasing"] = phasing

    fam_sets = []
    for edges, _count in families:
        es = set(edges)
        fam_sets.append((es, {f for f, _ in es}, {t for _, t in es}))

    path_segments = get_path_segments_for_family(
        graph, sorted(uber_edges))
    path_segments.sort(key=lambda p: p.nodes[0])

    # group path segments into haplotype groups by overlapping node spans
    starts: Dict[int, List[int]] = {}
    for ix, ps in enumerate(path_segments):
        starts.setdefault(ps.nodes[0], []).append(ix)

    groups: List[dict] = []
    has_group = False
    for s in sorted(starts):
        idxs = starts[s]
        ends = [path_segments[ix].nodes[-1] for ix in idxs]
        if has_group and groups[-1]["end"] <= s:
            has_group = False
        if not has_group:
            groups.append({"start": s, "end": max(ends), "paths": []})
            has_group = True
        groups[-1]["end"] = max(groups[-1]["end"], max(ends))
        groups[-1]["paths"].extend(idxs)

    # merge adjacent haplotype groups when every cross pairing is backed by
    # an observed family (HaplotypePaths.cpp:259-360)
    gi = 0
    while gi + 1 < len(groups):
        this_g = groups[gi]
        next_g = groups[gi + 1]
        has_merged = False
        group_merge_paths: List[LitePath] = []
        all_ok = True
        for p1 in this_g["paths"]:
            p1_merge_paths = []
            can_merge = True
            for p2 in next_g["paths"]:
                pp1 = path_segments[p1]
                pp2 = path_segments[p2]
                if pp1.nodes[-1] == pp2.nodes[0]:
                    merged = merge_paths(pp1, pp2)
                    for es, outn, inn in fam_sets:
                        if (path_contains(es, outn, inn, pp1.nodes)
                                and path_contains(es, outn, inn, pp2.nodes)
                                and path_contains(es, outn, inn,
                                                  merged.nodes)):
                            p1_merge_paths.append(merged)
                            break
                else:
                    can_merge = False
                    break
            if not can_merge:
                all_ok = False
                break
            if p1_merge_paths and (
                    len(this_g["paths"]) == 1 or len(next_g["paths"]) == 1
                    or len(p1_merge_paths) == 1):
                group_merge_paths.extend(p1_merge_paths)
                has_merged = True
            else:
                all_ok = False
                break
        if all_ok and has_merged:
            count_diff = (len(this_g["paths"]) + len(next_g["paths"])
                          - len(group_merge_paths))
            first_deleted = min(min(this_g["paths"]), min(next_g["paths"]))
            last_deleted = max(max(this_g["paths"]), max(next_g["paths"]))
            path_segments[first_deleted:last_deleted + 1] = \
                group_merge_paths
            new_hg = {
                "start": min(p.nodes[0] for p in group_merge_paths),
                "end": max(p.nodes[-1] for p in group_merge_paths),
                "paths": list(range(first_deleted,
                                    first_deleted + len(group_merge_paths))),
            }
            groups[gi:gi + 2] = [new_hg]
            for g in groups[gi + 1:]:
                g["paths"] = [p - count_diff for p in g["paths"]]
            gi = 0
        else:
            gi += 1

    path_ix = []
    out_paths = list(paths_json or [])
    for ps in path_segments:
        path_id = "_".join(str(n) for n in ps.nodes)
        haplo_json = {
            "path_length": ps.length(graph),
            "path_start": ps.start,
            "path_end": ps.end,
            "path_encoding": ps.encode(graph),
            "nodes": [graph.node_name(n) for n in ps.nodes],
            "path_id": path_id,
        }
        path_ix.append(len(out_paths))
        out_paths.append(haplo_json)
    output["paths"] = out_paths

    hap_groups = []
    for hg in groups:
        hap_groups.append({
            "start_node": hg["start"],
            "end_node": hg["end"],
            "paths": [out_paths[path_ix[p]]["path_id"]
                      for p in hg["paths"]],
        })
    output["phased_path_groups"] = hap_groups
