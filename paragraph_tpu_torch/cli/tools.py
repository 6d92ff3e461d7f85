"""Secondary tools: multiparagraph, addVariants, grmpy-vcf-merge, msa2vcf,
compare-alignments, pam and simulate-reads.

Equivalents of the reference's src/python/bin helpers, copied from
``paragraph_tpu/cli/tools.py``. Only multiparagraph touches a device: it
scores each event's reads through the single-graph fill on ``--device``
(default cuda), as the ``paragraph`` tool does.
"""
from __future__ import annotations

import argparse
import difflib
import gzip
import json
import sys
from collections import defaultdict
from pprint import pformat

from .main import _add_device_arg, _load_json


# ---------------------------------------------------------------------------
# addVariants (bin/addVariants.py + vcfgraph/variants.py)
# ---------------------------------------------------------------------------

def split_node(graph, node, breakpoints):
    """Split `node` at the given in-node offsets and relink its edges.

    Behavioural equivalent of the reference's splitNode
    (src/python/lib/grm/vcfgraph/variants.py:48-89), built around an
    explicit segment plan instead of a running split loop: the cut
    offsets (with 0 and node length as sentinels) define half-open
    [lo, hi) segments, each materialised as a ref/alt piece in one pass;
    a cut at 0 or at the node length yields an empty piece, exactly as
    the reference produces (remove_empty_nodes cleans those up later).
    Incoming edges transfer to the first piece, outgoing to the last,
    interior pieces chain, and the original node is dropped unless a
    piece reused its name."""
    cuts = sorted(set(breakpoints))
    if not cuts:
        return [node]
    length = node["end"] - node["start"] + 1
    assert all(0 <= c <= length for c in cuts)
    bounds = [0] + cuts + [length]
    is_ref = "reference" in node

    def piece(lo, hi):
        a = node["start"] + lo
        b = node["start"] + hi - 1
        if is_ref:
            return graph.add_ref_node(node["chrom"], a, b,
                                      node["sequences"])
        return graph.add_alt_node(node["chrom"], a, b,
                                  node["sequence"][lo:hi],
                                  node["sequences"])

    pieces = [piece(lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    for e in list(graph.in_edges(node)):
        graph.add_edge(graph.nodes[e["from"]], pieces[0], e["sequences"])
    for e in list(graph.out_edges(node)):
        graph.add_edge(pieces[-1], graph.nodes[e["to"]], e["sequences"])
    for left, right in zip(pieces, pieces[1:]):
        graph.add_edge(left, right)
    if all(p["name"] != node["name"] for p in pieces):
        graph.del_node(node)
    return pieces


def add_variants_node(graph, node, variants):
    """Insert alt branches for in-node variants (variants.py:92-108
    equivalent): validate every record up front, derive the cut set from
    the union of variant boundaries, split once, then wire one alt node
    per variant between the pieces flanking it (located through
    start/end-coordinate indexes over the pieces)."""
    for start, end, _alt in variants:
        if start > end + 1:
            raise ValueError("Variant start > end")
    for start, end, alt in variants:
        if start == end + 1 and not alt:
            raise ValueError("Insertion without sequence")
    cut_set = {c for s, e, _ in variants for c in (s, e + 1)}
    pieces = split_node(graph, node, sorted(cut_set))
    by_end = {p["end"]: p for p in pieces[:-1]}
    by_start = {p["start"]: p for p in pieces}
    for start, end, alt in variants:
        lo = node["start"] + start
        hi = node["start"] + end
        branch = graph.add_alt_node(node["chrom"], lo, hi, alt)
        graph.add_edge(by_end[lo - 1], branch)
        graph.add_edge(branch, by_start[hi + 1])


def add_variants(graph, var_dict):
    """Per-node loop of addVariants (variants.py:27-45 equivalent):
    malformed records skip their node with a stderr note — the
    reference is deliberately forgiving here."""
    for node_name, recs in var_dict.items():
        triples = [(r.get("start", 0), r.get("end", 0), r.get("alt", ""))
                   for r in recs]
        try:
            add_variants_node(graph, graph.nodes[node_name], triples)
        except Exception as exc:  # noqa: BLE001 — reference behaviour
            print(f"Skipping variant records on node {node_name}: {exc}",
                  file=sys.stderr)


def cmd_add_variants(argv):
    from ..graph.build import load_json as load_graph_json
    from ..graph.build import remove_empty_nodes

    p = argparse.ArgumentParser("addVariants")
    p.add_argument("graph")
    p.add_argument("output")
    p.add_argument("--variants", default=None)
    args = p.parse_args(argv)
    graph_dict = _load_json(args.graph)
    graph = load_graph_json(graph_dict)
    if args.variants:
        var_json = _load_json(args.variants)
        if "variants" not in var_json:
            raise ValueError("No variants in variant JSON")
        var_dict = var_json["variants"]
    else:
        var_dict = graph_dict.get("variants", {})
    add_variants(graph, var_dict)
    remove_empty_nodes(graph)
    with open(args.output, "w") as f:
        json.dump(graph.json_dict(), f, sort_keys=True)
    return 0


# ---------------------------------------------------------------------------
# multiparagraph (bin/multiparagraph.py): per-event paragraph runs + merge
# ---------------------------------------------------------------------------

def cmd_multiparagraph(argv):
    """bin/multiparagraph.py equivalent (run(): multiparagraph.py:184-252,
    run_paragraph(): :37-127): load event lists, build template graphs for
    events without one (make_graph), run the per-graph paragraph pipeline
    and merge the per-event outputs into one sorted JSON array. Each
    event's reads are scored on --device; on cuda a missing card or a
    failed launch raises."""
    from .. import resolve_device
    from ..graph.templates import make_graph
    from ..io.cram import open_alignment_reader as BamReader
    from ..pipeline.paragraph import (EDGE_READ_COUNTS, NODE_READ_COUNTS,
                                      PATH_READ_COUNTS, ALL, Parameters,
                                      align_and_disambiguate)
    from ..reads.extraction import extract_reads

    p = argparse.ArgumentParser("multiparagraph")
    p.add_argument("input", nargs="+",
                   help="JSON files, each a list of event descriptions")
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-r", "--reference-sequence", dest="ref", required=True)
    p.add_argument("-E", "--extended-output", action="store_true",
                   default=False)
    p.add_argument("--max-events", type=int, default=None)
    p.add_argument("--min-length", type=int, default=0)
    p.add_argument("-M", "--max-reads", type=int, default=10000)
    _add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    # event list assembly + length annotations (multiparagraph.py:203-238)
    all_events = []
    for filename in args.input:
        events = _load_json(filename)
        if not isinstance(events, list):
            raise ValueError("Input JSON must contain a list of events.")
        for e in events:
            if not isinstance(e, dict):
                raise ValueError("Invalid event description: %s" % str(e))
            e["ins_len"] = len(e["ins"]) if "ins" in e else 0
            if "end" in e and "start" in e:
                e["del_len"] = max(0, e["end"] - e["start"] + 1)
            else:
                e["del_len"] = 0
            e["len"] = max(e["ins_len"], e["del_len"])
            e.pop("samples", None)
        all_events += events

    if args.max_events is not None:
        all_events = all_events[:args.max_events]
    all_events = [e for e in all_events if e["len"] >= args.min_length]
    for i, e in enumerate(all_events):
        e["n_ev"] = i

    if args.extended_output:
        outputs = ALL
    else:
        # paragraph binary defaults (main/paragraph.cpp:65-66)
        outputs = NODE_READ_COUNTS | EDGE_READ_COUNTS | PATH_READ_COUNTS

    reader = BamReader(args.bam, "", args.ref)
    for event in all_events:
        if "graph" not in event:
            event["type"], event["graph"] = make_graph(args.ref, event)
        elif "type" not in event:
            event["type"] = "custom"
        event["commandline"] = (
            "paragraph -r %s -b %s" % (args.ref, args.bam))
        parameters = Parameters(max_reads=args.max_reads,
                                output_options=outputs)
        parameters.load(event["graph"], args.ref)
        reads = extract_reads(reader, parameters.target_regions,
                              parameters.max_reads,
                              parameters.longest_alt_insertion)
        out = align_and_disambiguate(parameters, reads, device=device)
        out["bam"] = args.bam
        event["graph"] = out

    opener = gzip.open if args.output.endswith(".gz") else open
    with opener(args.output, "wt") as f:
        json.dump(all_events, f, sort_keys=True, indent=4,
                  separators=(",", ": "))
    return 0


# ---------------------------------------------------------------------------
# grmpy-vcf-merge (bin/grmpy-vcf-merge.py): merge per-sample genotype VCFs
# ---------------------------------------------------------------------------

def cmd_grmpy_vcf_merge(argv):
    from ..io.vcf import VcfReader, VcfWriter

    p = argparse.ArgumentParser("grmpy-vcf-merge")
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="per-sample genotypes VCFs")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    readers = [VcfReader(path) for path in args.input]
    all_samples = []
    for r in readers:
        for s in r.samples:
            if s not in all_samples:
                all_samples.append(s)
    writer = VcfWriter(args.output, readers[0].header_lines, all_samples)
    iters = [iter(r) for r in readers]
    rows = [next(i, None) for i in iters]
    while any(r is not None for r in rows):
        keys = [(r.chrom, r.pos, r.ref, r.alts) for r in rows
                if r is not None]
        key = min(keys, key=lambda k: (k[0], k[1]))
        merged = None
        for idx, r in enumerate(rows):
            if r is not None and (r.chrom, r.pos, r.ref, r.alts) == key:
                if merged is None:
                    merged = r
                else:
                    merged.sample_values.update(r.sample_values)
                rows[idx] = next(iters[idx], None)
        for s in all_samples:
            merged.sample_values.setdefault(
                s, {k: "." for k in merged.fmt_keys})
        writer.write(merged)
    writer.close()
    return 0


# ---------------------------------------------------------------------------
# msa2vcf (bin/msa2vcf.py + lib msa.py): multiple alignment → VCF records
# ---------------------------------------------------------------------------

def _vcf_anchor_pad(v, ref, offset, last_end):
    """Prepend the VCF anchor base to a pure insertion/deletion record
    (start moves one reference base left) when that base is free, i.e.
    not already claimed by the previous variant."""
    if v["start"] < last_end:
        return
    if not v["alt"]:
        v["start"] -= 1
        v["ref"] = ref[v["start"] - offset] + v["ref"]
        v["alt"] = v["ref"][0] + v["alt"]
    elif not v["ref"]:
        v["start"] -= 1
        v["ref"] = ref[v["start"] - offset]
        v["alt"] = v["ref"] + v["alt"]


def pairwise_msa_variants(ref_aln, alt_aln, offset=0):
    """Variant calls between two rows of an MSA.

    Same contract as the reference's grm.msa.pairwise_variants
    (src/python/lib/grm/msa.py:60-129), structured as a column
    state machine: each alignment column is classified (match /
    double-gap / substitution / insertion / deletion) and folded into
    an open difference run. A column with bases in both rows closes the
    open run; double-gap columns keep it open; the run's anchor pins to
    the reference base before its first consumed ref character, and
    advances past each emitted record — a leading unanchored insertion
    is dropped, as in the reference. A second phase sorts the records,
    VCF-pads pure indels, and right-trims shared trailing bases where
    the previous record has not claimed the position.
    `start`/`end` are 0-based reference coordinates (+offset)."""
    assert len(ref_aln) == len(alt_aln)
    variants = []
    refs = []               # ref characters of the open run
    alts = []               # alt characters of the open run
    anchor = -1             # ref coordinate anchoring the open run
    ref_pos = 0             # reference bases consumed so far

    def emit(end):
        variants.append({"start": anchor + offset, "end": end,
                         "ref": "".join(refs), "alt": "".join(alts)})
        refs.clear()
        alts.clear()

    for r, a in zip(ref_aln, alt_aln):
        if r != "-" and a != "-" and anchor >= 0 and (refs or alts):
            emit(anchor + offset + len(refs) - 1)
            anchor = ref_pos
        if r == a:                      # match or double-gap column
            ref_pos += r != "-"
            continue
        if a == "-":                    # deletion column
            refs.append(r)
            ref_pos += 1
        elif r == "-":                  # insertion column
            alts.append(a)
        else:                           # substitution column
            refs.append(r)
            alts.append(a)
            ref_pos += 1
        if len(refs) == 1:
            anchor = ref_pos - 1
    if anchor >= 0 and (refs or alts):
        emit(anchor + len(ref_aln) - 1 + offset)

    variants.sort(key=lambda v: v["start"])
    ref = ref_aln.replace("-", "")
    last_end = offset
    for v in variants:
        _vcf_anchor_pad(v, ref, offset, last_end)
        while (v["start"] > last_end and v["ref"] and v["alt"]
               and v["ref"][-1] == v["alt"][-1]):
            v["end"] -= 1
            v["ref"] = v["ref"][:-1]
            v["alt"] = v["alt"][:-1]
            _vcf_anchor_pad(v, ref, offset, last_end)
        _vcf_anchor_pad(v, ref, offset, last_end)
        last_end = v["end"]
    return variants


def msa_to_records(ref_name, sequences, chrom="msa", offset=1):
    """Derive VCF-style records from an MSA dict {name: aligned_seq} where
    `ref_name` selects the reference row ('-' = gap). Records are
    (chrom, 1-based pos, ref, alt, sample) using the merged pairwise
    caller above (one record per indel/substitution run, VCF-padded)."""
    ref_aln = sequences[ref_name]
    records = []
    for name, aln in sequences.items():
        if name == ref_name:
            continue
        for v in pairwise_msa_variants(ref_aln, aln, offset - 1):
            records.append((chrom, v["start"] + 1, v["ref"], v["alt"],
                            name))
    records.sort(key=lambda rec: (rec[1], rec[4]))
    return records


def cmd_msa2vcf(argv):
    p = argparse.ArgumentParser("msa2vcf")
    p.add_argument("input", help="MSA FASTA (aligned, with '-' gaps)")
    p.add_argument("output")
    p.add_argument("--ref-name", default=None)
    p.add_argument("--chrom", default="msa")
    args = p.parse_args(argv)
    seqs = {}
    name = None
    with open(args.input) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = ""
            elif name:
                seqs[name] += line
    ref_name = args.ref_name or next(iter(seqs))
    records = msa_to_records(ref_name, seqs, args.chrom)
    with open(args.output, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={args.chrom}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for chrom, pos, ref, alt, name in records:
            f.write(f"{chrom}\t{pos}\t{name}\t{ref or '.'}\t"
                    f"{alt or '.'}\t.\t.\t.\n")
    return 0


# ---------------------------------------------------------------------------
# compare-alignments (bin/compare-alignments.py)
# ---------------------------------------------------------------------------

def cmd_compare_alignments(argv):
    p = argparse.ArgumentParser("compare-alignments")
    p.add_argument("json1")
    p.add_argument("json2")
    args = p.parse_args(argv)
    data1 = _load_json(args.json1)
    data2 = _load_json(args.json2)

    by_id = defaultdict(lambda: {"data1": [], "data2": []})
    for key, data in (("data1", data1), ("data2", data2)):
        for aln in data.get("alignments", []):
            alid = (aln.get("fragmentId", "") + "-mapped-to-"
                    + f"{aln.get('chromId', 0)}:{aln.get('pos', 0)}")
            by_id[alid][key].append(aln)
    for k, pair in by_id.items():
        if len(pair["data1"]) != len(pair["data2"]):
            print(f"[COUNT] Alignment with different counts: {k} / "
                  f"{len(pair['data1'])} != {len(pair['data2'])}")
            continue
        d1 = pformat(pair["data1"])
        d2 = pformat(pair["data2"])
        if d1 != d2:
            print(f"[DIFF] Difference detected for {k}:")
            for line in difflib.Differ().compare(
                    d1.splitlines(), d2.splitlines()):
                print("[DETAILS] " + line)
    return 0


# ---------------------------------------------------------------------------
# pam (main/pam.cpp): depth extraction over regions. The reference binary is
# a parameter-loading skeleton; here it reports per-region read counts and
# coverage from the BAM.
# ---------------------------------------------------------------------------

def cmd_pam(argv):
    from ..io.cram import open_alignment_reader as BamReader
    from ..io.regions import Region

    p = argparse.ArgumentParser("pam")
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--depth-spec", required=True,
                   help="JSON with {'regions': ['chr:start-end', ...]}")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-T", "--target-regions", default="")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-M", "--max-reads-per-event", type=int, default=10000)
    args = p.parse_args(argv)

    spec = _load_json(args.depth_spec)
    regions = (args.target_regions.split(",") if args.target_regions
               else spec.get("regions") or spec.get("target_regions", []))
    reader = BamReader(args.bam, "", args.reference)
    out = {"bam": args.bam, "regions": []}
    for region_str in regions:
        region = Region.from_string(region_str)
        tid = reader.contig_map.get(region.chrom)
        n_reads = 0
        bases = 0
        if tid is not None:
            for rec in reader.fetch(tid, region.start - 1, region.end):
                n_reads += 1
                bases += len(rec.bases)
                if n_reads >= args.max_reads_per_event:
                    break
        out["regions"].append({
            "region": region_str,
            "reads": n_reads,
            "depth": bases / region.length if region.length else 0,
        })
    sink = sys.stdout if args.output in ("-", "") else open(args.output, "w")
    json.dump(out, sink, sort_keys=True, indent=2)
    if sink is not sys.stdout:
        sink.close()
    return 0


# ---------------------------------------------------------------------------
# simulate-reads: replacement for the reference's EAGLE-based validation
# harness (doc/validation-with-simulated-reads.md): sample error-injected
# reads from each graph path; read names carry the truth path for
# ValidationAligner's empirical MAPQ accounting.
# ---------------------------------------------------------------------------

def simulate_reads_from_graph(graph, paths, read_length=100, depth=30,
                              error_rate=0.005, seed=42):
    """Yield (name, bases) tuples; name = '<path-id>:<n>' where path-id is
    the node-id chain joined with '_' (matches ValidationAligner keys)."""
    import random as _random

    rng = _random.Random(seed)
    bases_alpha = "ACGT"
    for node_ids in paths:
        path_id = "_".join(str(n) for n in node_ids)
        seq = "".join(graph.node_seq(n) for n in node_ids)
        if len(seq) < read_length:
            continue
        n_reads = max(1, depth * len(seq) // read_length)
        for i in range(n_reads):
            start = rng.randint(0, len(seq) - read_length)
            read = list(seq[start:start + read_length])
            for j in range(len(read)):
                if rng.random() < error_rate:
                    read[j] = rng.choice(bases_alpha)
            yield f"{path_id}:{i}", "".join(read)


def cmd_simulate_reads(argv):
    from ..graph.model import SequenceGraph, paths_from_json

    p = argparse.ArgumentParser("simulate-reads")
    p.add_argument("-g", "--graph-spec", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--output", required=True, help="FASTA output")
    p.add_argument("-l", "--read-length", type=int, default=100)
    p.add_argument("-d", "--depth", type=int, default=30)
    p.add_argument("-e", "--error-rate", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    desc = _load_json(args.graph_spec)
    if "graph" in desc:
        desc = {**desc, **desc["graph"]}
    graph = SequenceGraph.from_json(desc, args.reference)
    paths = paths_from_json(graph, desc.get("paths"))
    with open(args.output, "w") as f:
        for name, read in simulate_reads_from_graph(
                graph, paths, args.read_length, args.depth,
                args.error_rate, args.seed):
            f.write(f">{name}\n{read}\n")
    return 0
