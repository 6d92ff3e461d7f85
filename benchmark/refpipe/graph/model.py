"""Sequence graph data models.

Two representations:

- ``GraphContainer``: the host-side construction model used while converting
  VCFs to graphs (dict-based nodes/edges with haplotype label sets) —
  functional equivalent of the reference's python GraphContainer
  (src/python/lib/grm/vcfgraph/graphContainer.py).

- ``SequenceGraph``: the immutable, topologically-ordered model the aligner
  and genotyper operate on — functional equivalent of graph-tools'
  ``graphtools::Graph`` built by grm::graphFromJson
  (src/c++/lib/grm/GraphInput.cpp:51-161). Node ids are dense ints in
  topological order; predecessors/successors are returned sorted (the C++
  uses std::set<NodeId>, which gssw node wiring depends on).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set, Tuple


class GraphContainer:
    """Mutable construction graph for VCF→graph conversion.

    Nodes and edges are plain dicts in the paragraph graph-JSON
    vocabulary — ``to_json``/``json_dict`` emits them verbatim minus the
    build-time bookkeeping keys (chrom/start/end/label sets). Adjacency
    lives in two ``name → {peer-name: edge}`` maps plus one global
    ``(from, to) → edge`` map, all insertion-ordered: enumeration order
    of nodes and of each node's edges is part of this class's contract,
    because the topological sort below seeds from it and the resulting
    node ids drive aligner tie-breaking downstream.

    Reference nodes are additionally indexed by their span endpoints for
    O(1) junction lookups during conversion (``ref_node_starting_at`` /
    ``ref_node_ending_at``). These indexes always hold the most recently
    added node for a coordinate; conversion passes only consult them
    before any node sharing that coordinate is deleted.
    """

    def __init__(self, name: str = "VCF Graph"):
        self.name = name
        self.chroms: Set[str] = set()
        self.target_regions = None
        self.sequences: Set[str] = set()  # every haplotype label seen
        self.paths: List[dict] = []
        self.nodes: Dict[str, dict] = {}
        self._edge_map: Dict[Tuple[str, str], dict] = {}
        self._out: Dict[str, Dict[str, dict]] = defaultdict(dict)
        self._in: Dict[str, Dict[str, dict]] = defaultdict(dict)
        self._ref_span_start: Dict[Tuple[str, int], dict] = {}
        self._ref_span_end: Dict[Tuple[str, int], dict] = {}

    # ------------------------------------------------------------------
    # nodes
    # ------------------------------------------------------------------

    def _install(self, node: dict, labels: Iterable[str]) -> dict:
        self.nodes[node["name"]] = node
        self.chroms.add(node["chrom"])
        self.sequences.update(labels)
        return node

    def add_ref_node(self, chrom, start, end, sequences=(), name=None):
        span = f"{chrom}:{start}-{end}"
        node = {"name": name or f"ref-{span}", "reference": span,
                "sequences": set(sequences),
                "chrom": chrom, "start": start, "end": end}
        self._ref_span_start[chrom, start] = node
        self._ref_span_end[chrom, end] = node
        return self._install(node, sequences)

    def add_alt_node(self, chrom, start, end, sequence, sequences=(),
                     name=None):
        span = f"{chrom}:{start}-{end}"
        node = {"name": name or f"{span}:{sequence}", "position": span,
                "sequence": sequence, "sequences": set(sequences),
                "chrom": chrom, "start": start, "end": end}
        return self._install(node, sequences)

    def adopt_node(self, node: dict) -> dict:
        """Install a pre-built node dict (source/sink placeholders and
        JSON passthrough nodes carry no span bookkeeping)."""
        self.nodes[node["name"]] = node
        return node

    def ref_node_starting_at(self, chrom: str, pos: int) -> dict:
        return self._ref_span_start[chrom, pos]

    def ref_node_ending_at(self, chrom: str, pos: int) -> dict:
        return self._ref_span_end[chrom, pos]

    def del_node(self, node: dict):
        name = node["name"]
        for e in list(self._out[name].values()):
            self.del_edge(e)
        for e in list(self._in[name].values()):
            self.del_edge(e)
        del self.nodes[name]

    def ref_nodes(self, chrom: Optional[str] = None):
        return (n for n in self.nodes.values() if "reference" in n
                and (chrom is None or chrom == n.get("chrom")))

    def alt_nodes(self, chrom: Optional[str] = None):
        return (n for n in self.nodes.values() if "reference" not in n
                and (chrom is None or chrom == n.get("chrom")))

    def nodes_by_haplo(self, haplo: str) -> List[dict]:
        """Nodes labelled with `haplo`, by (start, end); ties keep
        insertion order (stable sort)."""
        ns = [n for n in self.nodes.values()
              if haplo in n.get("sequences", ())]
        ns.sort(key=lambda n: (n["start"], n["end"]))
        return ns

    # ------------------------------------------------------------------
    # edges
    # ------------------------------------------------------------------

    def add_edge(self, node_from: dict, node_to: dict,
                 haplos: Iterable[str] = ()) -> dict:
        key = (node_from["name"], node_to["name"])
        if key[0] == key[1]:
            raise ValueError(f"refusing self-edge on node {key[0]}")
        edge = self._edge_map.get(key)
        if edge is None:
            edge = {"from": key[0], "to": key[1], "sequences": set(),
                    "name": f"{key[0]}_{key[1]}"}
            self._edge_map[key] = edge
            self._out[key[0]][key[1]] = edge
            self._in[key[1]][key[0]] = edge
        edge["sequences"].update(haplos)
        self.sequences.update(haplos)
        return edge

    def del_edge(self, edge: dict):
        key = (edge["from"], edge["to"])
        del self._edge_map[key]
        del self._out[key[0]][key[1]]
        del self._in[key[1]][key[0]]

    def has_edge(self, node_from: dict, node_to: dict) -> bool:
        return (node_from["name"], node_to["name"]) in self._edge_map

    def get_edge(self, name_from: str, name_to: str) -> dict:
        return self._edge_map[name_from, name_to]

    def iter_edges(self):
        """All edges in creation order."""
        return iter(self._edge_map.values())

    def num_edges(self) -> int:
        return len(self._edge_map)

    def in_edges(self, node: dict, haplo: Optional[str] = None):
        for e in self._in[node["name"]].values():
            if haplo is None or haplo in e["sequences"]:
                yield e

    def out_edges(self, node: dict, haplo: Optional[str] = None):
        for e in self._out[node["name"]].values():
            if haplo is None or haplo in e["sequences"]:
                yield e

    # ------------------------------------------------------------------
    # derived views
    # ------------------------------------------------------------------

    def check(self):
        for (f, t), _e in self._edge_map.items():
            if f not in self.nodes or t not in self.nodes:
                raise AssertionError(f"edge {f}->{t} references a "
                                     "missing node")
            if f == t:
                raise AssertionError(f"self-edge on {f}")
        for p in self.paths:
            if p["sequence"] not in self.sequences:
                raise AssertionError(
                    f"path {p['path_id']} labelled with unknown sequence")
            for n in p["nodes"]:
                if n not in self.nodes:
                    raise AssertionError(f"path node {n} missing")

    def topological_sort(self):
        """Node order + node-order-sorted edges.

        Iterative reverse-postorder DFS, seeded from nodes in insertion
        order with children visited name-sorted. This exact order is a
        contract: it defines node ids, which the aligner's tie-breaking
        depends on (the goldens in tests/test_vcf2paragraph_golden.py
        pin it).
        """
        def children(node):
            succ = [self.nodes[d] for d in self._out[node["name"]]]
            succ.sort(key=lambda n: n["name"])
            return succ

        OPEN, DONE = 1, 2
        state: Dict[str, int] = {}
        postorder: List[dict] = []
        for root in list(self.nodes.values()):
            if root["name"] in state:
                continue
            state[root["name"]] = OPEN
            stack = [(root, iter(children(root)))]
            while stack:
                node, it = stack[-1]
                child = next(it, None)
                if child is None:
                    state[node["name"]] = DONE
                    postorder.append(node)
                    stack.pop()
                elif child["name"] not in state:
                    state[child["name"]] = OPEN
                    stack.append((child, iter(children(child))))
                elif state[child["name"]] == OPEN:
                    raise ValueError(
                        f"Graph has a cycle at {node['name']} -> "
                        f"{child['name']}")
        ordered_nodes = postorder[::-1]
        rank = {n["name"]: i for i, n in enumerate(ordered_nodes)}
        all_edges = sorted(self._edge_map.values(),
                           key=lambda e: (rank[e["from"]], rank[e["to"]]))
        return ordered_nodes, all_edges

    def get_reference_regions(self):
        """Merged reference spans per chromosome, as region strings."""
        for chrom in self.chroms:
            spans = sorted((n["start"], n["end"])
                           for n in self.ref_nodes(chrom))
            cur_s = cur_e = None
            for s, e in spans:
                if cur_e is not None and s <= cur_e + 1:
                    cur_e = max(cur_e, e)
                    continue
                if cur_s is not None:
                    yield f"{chrom}:{cur_s}-{cur_e}"
                cur_s, cur_e = s, e
            if cur_s is not None:
                yield f"{chrom}:{cur_s}-{cur_e}"

    _BOOKKEEPING_KEYS = ("mark", "vcfId", "chrom", "start", "end")

    def json_dict(self) -> dict:
        """Paragraph graph-JSON document (node order = topological)."""
        s_nodes, s_edges = self.topological_sort()

        def strip(d: dict, also=()) -> dict:
            return {k: v for k, v in d.items()
                    if k not in self._BOOKKEEPING_KEYS and k not in also}

        nodes = [strip(n, also=("sequences",)) for n in s_nodes]
        edges = []
        for e in s_edges:
            e = strip(e)
            if "sequences" in e:
                if e["sequences"]:
                    e["sequences"] = sorted(e["sequences"])
                else:
                    del e["sequences"]
            edges.append(e)
        return {
            "nodes": nodes,
            "edges": edges,
            "paths": self.paths,
            "target_regions": sorted(self.target_regions),
            "sequencenames": sorted(self.sequences),
            "model_name": self.name,
        }


class SequenceGraph:
    """Immutable aligned-graph model (graphtools::Graph equivalent).

    Nodes are ordered as in the JSON (must be topological: every edge goes
    from a lower to a higher node id, as asserted by the reference's gssw
    bridge GraphAligner.cpp:151).
    """

    def __init__(self, node_names: List[str], node_seqs: List[str]):
        self.node_names = list(node_names)
        self.node_seqs = list(node_seqs)
        self.name_to_id = {n: i for i, n in enumerate(node_names)}
        n = len(node_names)
        self._succ: List[Set[int]] = [set() for _ in range(n)]
        self._pred: List[Set[int]] = [set() for _ in range(n)]
        self._edge_labels: Dict[Tuple[int, int], Set[str]] = {}

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    def node_name(self, node_id: int) -> str:
        return self.node_names[node_id]

    def node_seq(self, node_id: int) -> str:
        return self.node_seqs[node_id]

    def add_edge(self, from_id: int, to_id: int):
        if from_id >= to_id:
            raise ValueError(
                f"Edges must be topological: {from_id} -> {to_id}")
        self._succ[from_id].add(to_id)
        self._pred[to_id].add(from_id)
        self._edge_labels.setdefault((from_id, to_id), set())

    def has_edge(self, from_id: int, to_id: int) -> bool:
        return (from_id, to_id) in self._edge_labels

    def add_label_to_edge(self, from_id: int, to_id: int, label: str):
        self._edge_labels[(from_id, to_id)].add(label)

    def edge_labels(self, from_id: int, to_id: int) -> Set[str]:
        return self._edge_labels.get((from_id, to_id), set())

    def successors(self, node_id: int) -> List[int]:
        return sorted(self._succ[node_id])

    def predecessors(self, node_id: int) -> List[int]:
        return sorted(self._pred[node_id])

    def edges(self):
        return sorted(self._edge_labels.keys())

    @classmethod
    def from_json(cls, desc: dict, reference_path: str = "",
                  fasta=None) -> "SequenceGraph":
        """Build from a paragraph graph JSON (grm::graphFromJson semantics).

        - source/sink placeholder nodes (first/last, named source/sink any
          case) get sequence "X" (GraphInput.cpp:86-89)
        - literal `sequence` is used verbatim; `reference` regions are
          fetched from the FASTA and uppercased (GraphInput.cpp:90-125)
        - node-level `sequences` labels are shortcuts for labelling all
          in/out edges (GraphInput.cpp:143-158)
        """
        if "graph" in desc:
            desc = {**desc, **desc["graph"]}
        nodes = desc["nodes"]
        names = []
        seqs = []
        if fasta is None and reference_path:
            from ..io.fasta import FastaFile

            fasta = FastaFile(reference_path)
        n_nodes = len(nodes)
        for i, jn in enumerate(nodes):
            name = jn.get("name", f"node-{i + 1}")
            names.append(name)
            is_source_or_sink = (
                i in (0, n_nodes - 1) and name.upper() in ("SOURCE", "SINK"))
            if is_source_or_sink:
                seqs.append("X")
            elif "sequence" in jn:
                seqs.append(jn["sequence"])
            else:
                ref = jn["reference"]
                if isinstance(ref, str):
                    seqs.append(fasta.query(ref))
                else:
                    seq = ""
                    for loc in ref:
                        cur = fasta.query(loc)
                        if seq:
                            assert seq == cur
                        seq = cur
                    seqs.append(seq)
        g = cls(names, seqs)
        for je in desc.get("edges") or []:
            f = g.name_to_id[je["from"]]
            t = g.name_to_id[je["to"]]
            g.add_edge(f, t)
            for label in je.get("sequences", []):
                g.add_label_to_edge(f, t, label)
        for i, jn in enumerate(nodes):
            for label in jn.get("sequences", []):
                for h in g.predecessors(i):
                    g.add_label_to_edge(h, i, label)
                for j in g.successors(i):
                    g.add_label_to_edge(i, j, label)
        return g

    def reversed(self) -> "SequenceGraph":
        """Reverse graph: node order, sequences and edges reversed
        (graphtools GraphOperations::reverseGraph)."""
        n = self.num_nodes
        names = [self.node_names[n - 1 - i] for i in range(n)]
        seqs = [self.node_seqs[n - 1 - i][::-1] for i in range(n)]
        g = SequenceGraph(names, seqs)
        for (f, t), labels in self._edge_labels.items():
            nf, nt = n - 1 - t, n - 1 - f
            g.add_edge(nf, nt)
            for l in labels:
                g.add_label_to_edge(nf, nt, l)
        return g


def paths_from_json(graph: SequenceGraph, json_paths) -> List[List[int]]:
    """Path node-id lists from JSON (grm::pathsFromJson)."""
    out = []
    for p in json_paths or []:
        out.append([graph.name_to_id[n] for n in p["nodes"]])
    return out
