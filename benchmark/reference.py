"""The benchmark's plain reference: what a correct program outputs, worked
out again from the benchmark's own inputs.

- ``graph_fill``: the graph Smith-Waterman fill of a batch of reads
  against one graph, in plain PyTorch (on the card for the realign
  check, on the host's cores for the genotyping records), with gssw's
  conventions as the paragraph aligner uses them (match 1, mismatch 4,
  gap open 6, extend 1; reads
  padded to a multiple of 16 rows that score 0; a node's first column
  seeded by the elementwise maximum of its predecessors' last columns).
  Per read it gives what the port's paired kernel reports: the best
  score, the node and in-node offset of its first column, the first row
  of that column holding it (capped at the last real row) and whether
  the best score ends in more than one node.
- ``four_orientations``: the aligner's protocol on one graph: forward
  and reverse-complement reads against the graph, their reversals
  against the reversed graph.
- ``event_records``: the per-sample genotyping records of chosen events,
  from the VCF, the FASTA and the BAMs, through ``refpipe`` (a frozen
  copy of the port's host pipeline, see its docstring) with the scores of
  ``four_orientations``.

It imports neither ``jax`` nor ``paragraph_tpu`` nor anything of
``paragraph_tpu_torch``, and takes nothing that the program made.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, List, Sequence

import numpy as np

MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 1, 4, 6, 1
_CODE = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


def codes_of(seq: str) -> np.ndarray:
    """A, C, G, T -> 0-3; anything else -> 4 (N, scores 0)."""
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


class Graph:
    """Node sequences (in topological order) and predecessor lists."""

    def __init__(self, seqs: List[str], preds: List[List[int]]):
        self.seqs = seqs
        self.preds = preds

    @classmethod
    def from_json(cls, desc: dict, fasta) -> "Graph":
        """From paragraph's graph JSON: `reference` regions fetched from
        `fasta` (a FastaFile of refpipe), `sequence` taken as is."""
        names = [n["name"] for n in desc["nodes"]]
        index = {n: i for i, n in enumerate(names)}
        seqs = [n["sequence"] if "sequence" in n else
                fasta.query(n["reference"]) for n in desc["nodes"]]
        preds: List[List[int]] = [[] for _ in names]
        for e in desc["edges"]:
            preds[index[e["to"]]].append(index[e["from"]])
        return cls([s.upper() for s in seqs],
                   [sorted(set(p)) for p in preds])

    def reversed(self) -> "Graph":
        n = len(self.seqs)
        preds: List[List[int]] = [[] for _ in range(n)]
        for t, ps in enumerate(self.preds):
            for f in ps:
                # edge f -> t becomes (n-1-t) -> (n-1-f)
                preds[n - 1 - f].append(n - 1 - t)
        return Graph([s[::-1] for s in reversed(self.seqs)],
                     [sorted(p) for p in preds])


def graph_fill(graph: Graph, reads: np.ndarray, lens: np.ndarray,
               clamp_to: int = 0, device: str = "cpu"
               ) -> Dict[str, np.ndarray]:
    """Fill reads [B, M] (codes, rows past each read's length ignored)
    against `graph`, in plain PyTorch on `device`; returns score,
    end_node, end_ref, end_read and multi per read, as NumPy arrays.
    `clamp_to`, when set, saturates every H value at it (the benchmark's
    lower-precision control)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device(device)
    i32 = torch.int32
    B, M = reads.shape
    vlen = -(-lens // 16) * 16
    m = int(vlen.max())
    rows = torch.arange(m, device=dev, dtype=i32)
    lens_t = torch.as_tensor(lens, device=dev)
    stripe = rows[None, :] < torch.as_tensor(vlen, device=dev)[:, None]
    real = rows[None, :] < lens_t[:, None]
    codes = torch.full((B, m), 5, dtype=torch.int64, device=dev)
    codes[:, :M] = torch.where(
        torch.arange(M, device=dev)[None, :] < lens_t[:, None],
        torch.as_tensor(reads, device=dev).long(), 5)
    # prof[c][b, j]: read row j of read b against reference class c
    prof = torch.zeros((5, B, m), dtype=i32, device=dev)
    for c in range(4):
        prof[c] = torch.where(codes == c, MATCH,
                              torch.where(codes < 4, -MISMATCH, 0))
    gterm = rows * GAP_EXTEND + (GAP_EXTEND - GAP_OPEN)
    step = rows[1:] * GAP_EXTEND
    neg = torch.tensor(-2 ** 30, dtype=i32, device=dev)
    n_nodes = len(graph.seqs)
    saved_h: List = [None] * n_nodes
    saved_e: List = [None] * n_nodes
    node_max = torch.zeros((n_nodes, B), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_node = torch.zeros(B, dtype=torch.int64, device=dev)
    best_ref = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_row = torch.zeros(B, dtype=torch.int64, device=dev)
    zero = torch.zeros((B, m), dtype=i32, device=dev)
    for nid, seq in enumerate(graph.seqs):
        preds = graph.preds[nid]
        h, e = zero, zero
        if preds:
            h, e = saved_h[preds[0]], saved_e[preds[0]]
            for p in preds[1:]:
                h = torch.maximum(h, saved_h[p])
                e = torch.maximum(e, saved_e[p])
        col_best = torch.zeros(B, dtype=i32, device=dev)
        for i, c in enumerate(codes_of(seq).tolist()):
            diag = F.pad(h[:, :-1], (1, 0))
            hp = torch.maximum((diag + prof[c]).clamp_min(0), e)
            g = torch.cummax(hp + gterm, dim=1).values
            f = F.pad((g[:, :-1] - step).clamp_min(0), (1, 0))
            h = torch.maximum(hp, f)
            if clamp_to:
                h = h.clamp_max(clamp_to)
            e = torch.maximum(e - GAP_EXTEND, h - GAP_OPEN)
            cm, arg = torch.where(stripe, h, neg).max(1)
            better = cm > best
            best = torch.where(better, cm, best)
            best_node = torch.where(better, nid, best_node)
            best_ref = torch.where(better, i, best_ref)
            best_row = torch.where(better, arg, best_row)
            col_best = torch.maximum(col_best,
                                     torch.where(real, h, 0).amax(1))
        saved_h[nid], saved_e[nid] = h, e
        node_max[nid] = col_best
    found = best > 0
    out = {
        "score": best,
        "end_node": torch.where(found, best_node, 0),
        "end_ref": torch.where(found, best_ref, -1),
        "end_read": torch.where(found, torch.minimum(best_row, lens_t - 1),
                                0),
        "multi": (node_max == best).sum(0) > 1,
    }
    return {k: v.to(i32).cpu().numpy() for k, v in out.items()}


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes)[..., ::-1]


def four_orientations(graph: Graph, reads: Sequence[str],
                      clamp_to: int = 0, device: str = "cpu"):
    """(f_out, r_out) of the aligner's protocol: f_out over [reads +
    their reverse complements] against `graph`, r_out over [their
    reversals] against the reversed graph; each a dict of graph_fill's
    arrays over 2n reads."""
    lens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    m = int(lens.max()) if len(reads) else 1
    fwd = np.full((len(reads), m), 4, np.int8)
    rc = np.full((len(reads), m), 4, np.int8)
    for k, r in enumerate(reads):
        c = codes_of(r)
        fwd[k, :len(c)] = c
        rc[k, :len(c)] = _revcomp(c)
    both = np.concatenate([fwd, rc])
    both_lens = np.concatenate([lens, lens])
    rev = np.zeros_like(both)
    for k, ln in enumerate(both_lens):
        rev[k, :ln] = both[k, :ln][::-1]
    f_out = graph_fill(graph, both, both_lens, clamp_to, device)
    r_out = graph_fill(graph.reversed(), rev, both_lens, clamp_to, device)
    return f_out, r_out


# --------------------------------------------------------------------------
# genotyping records of chosen events


def _align_one(task) -> dict:
    """One (event, sample)'s alignment output: reads extracted from the
    sample's BAM, scored in four orientations by graph_fill, then traced
    back, filtered, disambiguated and counted by refpipe."""
    graph_desc, ref_path, bam, bai, max_reads, device = task
    import torch

    from .refpipe.graph.model import SequenceGraph
    from .refpipe.io.bam import BamReader
    from .refpipe.pipeline.grmpy import (GrmpyParameters,
                                         _make_paragraph_parameters)
    from .refpipe.pipeline.paragraph import align_and_disambiguate
    from .refpipe.reads.extraction import extract_reads
    from .refpipe.reads.read import UNMAPPED

    params = GrmpyParameters(max_reads=max_reads)
    pp = _make_paragraph_parameters(params, graph_desc, ref_path, False)
    seq_graph = SequenceGraph.from_json(pp.description, ref_path)
    own = Graph(list(seq_graph.node_seqs),
                [list(seq_graph.predecessors(i))
                 for i in range(seq_graph.num_nodes)])
    reads = extract_reads(BamReader(bam, bai, ref_path), pp.target_regions,
                          params.max_reads, pp.longest_alt_insertion)
    torch.set_num_threads(1)  # one of several workers on the host
    live = [r for r in reads if r.bases]
    for r in live:
        r.graph_mapping_status = UNMAPPED
    f_out, r_out = four_orientations(own, [r.bases.upper() for r in live],
                                     device=device)
    scores = (f_out["score"], f_out["multi"], r_out["multi"],
              f_out["end_node"], f_out["end_ref"], f_out["end_read"])
    out = align_and_disambiguate(pp, reads, graph=seq_graph,
                                 precomputed_scores=scores, device="cpu")
    out["bam"] = bam
    for key in ("alignments", "node_coverage", "path_coverage", "phasing",
                "variants"):
        out.pop(key, None)
    return out


def _node_bases(graph_desc: dict) -> int:
    """Bases of a graph description's nodes (sequence or region)."""
    total = 0
    for n in graph_desc["nodes"]:
        if "sequence" in n:
            total += len(n["sequence"])
        elif "reference" in n:
            lo, hi = n["reference"].rsplit(":", 1)[1].split("-")
            total += int(hi) - int(lo) + 1
    return total


def event_records(workdir: str, cfg: dict, event_indices: Sequence[int],
                  sample_names: Sequence[str], engine: str = "host",
                  round_to=None, processes: int = 1,
                  device: str = "cpu") -> Dict[int, dict]:
    """{event index: {sample: its genotyping record}} for the catalogue
    events `event_indices` (their VCF blocks, in order), worked out through
    refpipe from ``candidates.vcf``, ``ref.fa`` and the samples' BAMs,
    each (event, sample) aligned in one of `processes` spawned workers.

    `engine` "host" genotypes in float64 (the host engine); "batch" in the
    float32 batch model, with `round_to` (a torch dtype) as the control's
    lower precision."""
    import multiprocessing
    import os

    from .refpipe.genotyping import batched
    from .refpipe.genotyping.device_engine import genotype_events_on_device
    from .refpipe.genotyping.sample_info import load_manifest
    from .refpipe.pipeline.grmpy import make_event_genotyper
    from .refpipe.pipeline.multigrmpy import (MultigrmpyOptions,
                                              convert_vcf_to_json)

    opts = cfg["options"]
    ref_path = os.path.join(workdir, "ref.fa")
    options = MultigrmpyOptions(
        input=os.path.join(workdir, "candidates.vcf"), reference=ref_path,
        split_type=opts["split_type"], read_length=opts["read_length"],
        max_ref_node_length=opts["max_ref_node_length"])
    _, _, _, variants = convert_vcf_to_json(options, alt_paths=True)
    wanted = set(event_indices)
    chosen = []
    for k, event in enumerate(variants):
        if k in wanted:
            graph = event["graph"]
            graph["ID"] = event["ID"]
            chosen.append((k, graph))
    manifest = [s for s in load_manifest(os.path.join(workdir,
                                                      "samples.txt"))
                if s.sample_name in sample_names]
    max_reads = opts["max_reads_per_event"] or 10000
    tasks = [(graph, ref_path, s.filename, s.index_filename, max_reads,
              device) for _, graph in chosen for s in manifest]
    if processes > 1:
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(processes)
        try:
            # the longest graphs first, so none starts last
            order = sorted(range(len(tasks)),
                           key=lambda k: -_node_bases(tasks[k][0]))
            outs = [None] * len(tasks)
            for k, out in zip(order, pool.map(
                    _align_one, [tasks[k] for k in order], chunksize=1)):
                outs[k] = out
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    else:
        outs = [_align_one(t) for t in tasks]
    genotypers = []
    for k, (_, graph) in enumerate(chosen):
        samples = []
        for j, s in enumerate(manifest):
            s = copy.copy(s)
            s.alignment_data = outs[k * len(manifest) + j]
            samples.append(s)
        genotypers.append(make_event_genotyper(graph, ref_path, None,
                                               samples))
    if engine == "batch":
        batched.ROUND_TO = round_to
        try:
            genotype_events_on_device(genotypers, "cpu")
        finally:
            batched.ROUND_TO = None
    result = {}
    for (pos, _), gtr in zip(chosen, genotypers):
        rec = gtr.get_genotypes()
        result[pos] = json.loads(json.dumps(rec["samples"]))
    return result
