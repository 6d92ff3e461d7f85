"""Command-line tools of the PyTorch / CUDA port: the fifteen tools of
``python -m paragraph_tpu.cli.main`` (multigrmpy, grmpy, paragraph,
idxdepth, vcf2paragraph, graph-to-fasta, kmerstats, paragraph2dot, and
through ``cli/tools.py`` multiparagraph, addVariants, grmpy-vcf-merge,
msa2vcf, compare-alignments, pam, simulate-reads).

The options are those of the JAX package's tools. The four that score
reads (multigrmpy, grmpy, paragraph, multiparagraph) also take
``--device {cuda,cpu}`` (default cuda). Invoke as
``python -m paragraph_tpu_torch.cli.main <tool> [options]`` or through
the ``paragraph-tpu-torch`` console script.
"""
from __future__ import annotations

import argparse
import gzip
import json
import sys


def _open_out(path):
    if path in ("-", "", None):
        return sys.stdout
    if path.endswith(".gz"):
        return gzip.open(path, "wt")
    return open(path, "w")


def _load_json(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _add_logging_args(p):
    """Shared logging options (common::Options base, Program.cpp:54-61)."""
    p.add_argument("--log-level", default="info",
                   choices=["trace", "debug", "info", "warning", "error"])
    p.add_argument("--log-file", default="")
    p.add_argument("--log-async", default="yes",
                   help="accepted for compatibility; no-op")


def _setup_logging(args):
    import logging

    level = {"trace": logging.DEBUG, "debug": logging.DEBUG,
             "info": logging.INFO, "warning": logging.WARNING,
             "error": logging.ERROR}[args.log_level]
    handlers = None
    if args.log_file:
        handlers = [logging.FileHandler(args.log_file)]
    logging.basicConfig(
        level=level, handlers=handlers,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")


def _expand_response_files(argv):
    """--response-file=FILE support (common::Options, Program.cpp:73-106):
    arguments are read whitespace-separated from the file."""
    out = []
    for arg in argv:
        if arg.startswith("--response-file="):
            with open(arg.split("=", 1)[1]) as f:
                out.extend(f.read().split())
        else:
            out.append(arg)
    return out


def _add_device_arg(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where graph-SW scoring runs (default cuda); cpu "
                        "runs the plain PyTorch fill")


def cmd_multigrmpy(argv):
    """multigrmpy.py equivalent (end-to-end VCF/JSON → genotypes)."""
    from ..pipeline.multigrmpy import MultigrmpyOptions, run

    p = argparse.ArgumentParser("multigrmpy")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", "--manifest", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-r", "--reference-sequence", dest="reference",
                   required=True)
    p.add_argument("--threads", "-t", type=int, default=0)
    p.add_argument("-G", "--genotyping-parameters", default="")
    p.add_argument("-M", "--max-reads-per-event", type=int, default=0)
    p.add_argument("--vcf-split", dest="split_type", default="lines",
                   choices=["lines", "full", "by_id", "superloci"])
    p.add_argument("-p", "--read-length", type=int, default=150)
    p.add_argument("-l", "--max-ref-node-length", type=int, default=300)
    p.add_argument("--retrieve-reference-sequence", action="store_true")
    p.add_argument("--graph-type", default="alleles",
                   choices=["alleles", "haplotypes"])
    p.add_argument("--ins-info-key", default="SEQ")
    p.add_argument("--no-alt-splitting", dest="alt_splitting",
                   action="store_false", default=True)
    p.add_argument("-A", "--write-alignments", action="store_true")
    p.add_argument("--infer-read-haplotypes", action="store_true")
    p.add_argument("--path-sequence-matching", action="store_true")
    p.add_argument("--graph-sequence-matching", default=True)
    p.add_argument("--bad-align-uniq-kmer-len", type=int, default=0)
    p.add_argument("--validate-schemas", action="store_true",
                   help="JSON-Schema validation of event graphs and "
                        "genotyping records (paragraph_tpu_torch/schema/)")
    p.add_argument("--genotyping-engine", default="auto",
                   choices=["auto", "host", "device"],
                   help="auto (default): host, or device for >=4 samples "
                        "and >=8 events; device genotypes the whole run in "
                        "float32 on --device (batch and pipelined paths; "
                        "per-event runs genotype on the host)")
    _add_device_arg(p)
    _add_logging_args(p)
    args = p.parse_args(argv)
    _setup_logging(args)

    gt_params = None
    if args.genotyping_parameters:
        if args.genotyping_parameters.strip().startswith("{"):
            gt_params = json.loads(args.genotyping_parameters)
        else:
            gt_params = _load_json(args.genotyping_parameters)

    options = MultigrmpyOptions(
        input=args.input,
        manifest=args.manifest,
        reference=args.reference,
        output=args.output,
        split_type=args.split_type,
        read_length=args.read_length,
        max_ref_node_length=args.max_ref_node_length,
        retrieve_reference_sequence=args.retrieve_reference_sequence,
        graph_type=args.graph_type,
        ins_info_key=args.ins_info_key,
        alt_splitting=args.alt_splitting,
        genotyping_parameters=gt_params,
        max_reads_per_event=args.max_reads_per_event,
        threads=args.threads,
        write_alignments=args.write_alignments,
        infer_read_haplotypes=args.infer_read_haplotypes,
        path_sequence_matching=args.path_sequence_matching,
        bad_align_uniq_kmer_len=args.bad_align_uniq_kmer_len,
        validate_schemas=args.validate_schemas,
        gt_engine=args.genotyping_engine,
    )
    out = run(options, device=args.device)
    print(json.dumps(out))
    return 0


def cmd_grmpy(argv):
    """grmpy equivalent (graphs + manifest → genotypes.json)."""
    from ..genotyping.sample_info import load_manifest
    from ..pipeline.grmpy import GrmpyParameters, run_grmpy
    from ..pipeline.parallel_grmpy import log_stages

    p = argparse.ArgumentParser("grmpy")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-g", "--graph-spec", nargs="+", required=True)
    p.add_argument("-m", "--manifest", required=True)
    p.add_argument("-o", "--output-file", default="-")
    p.add_argument("-G", "--genotyping-parameters", default="")
    p.add_argument("-M", "--max-reads-per-event", type=int, default=10000)
    p.add_argument("--bad-align-frac", type=float, default=0.8)
    p.add_argument("--path-sequence-matching", default=False)
    p.add_argument("--graph-sequence-matching", default=True)
    p.add_argument("--bad-align-uniq-kmer-len", type=int, default=0)
    p.add_argument("-t", "--sample-threads", type=int, default=0)
    p.add_argument("-z", "--gzip-output", action="store_true")
    p.add_argument("-A", "--alignment-output-folder", default="")
    p.add_argument("--infer-read-haplotypes", action="store_true")
    p.add_argument("--progress", action="store_true",
                   help="periodic N/M-events-done progress lines")
    p.add_argument("--genotyping-engine", default="auto",
                   choices=["auto", "host", "device"])
    _add_device_arg(p)
    _add_logging_args(p)
    args = p.parse_args(argv)
    _setup_logging(args)

    graphs = [_load_json(g) for g in args.graph_spec]
    manifest = load_manifest(args.manifest)
    gt_params = (_load_json(args.genotyping_parameters)
                 if args.genotyping_parameters else None)
    parameters = GrmpyParameters(
        threads=args.sample_threads,
        max_reads=args.max_reads_per_event,
        bad_align_frac=args.bad_align_frac,
        bad_align_uniq_kmer_len=args.bad_align_uniq_kmer_len,
        alignment_output_folder=args.alignment_output_folder.lstrip("!"),
        infer_read_haplotypes=args.infer_read_haplotypes,
        progress=args.progress,
        gt_engine=args.genotyping_engine,
    )
    kernel_stats: dict = {}
    results = run_grmpy(graphs, args.reference, manifest, gt_params,
                        parameters, device=args.device,
                        kernel_stats=kernel_stats)
    log_stages(kernel_stats)
    with _open_out(args.output_file) as f:
        json.dump(results, f, sort_keys=True, indent=2)
    return 0


def cmd_paragraph(argv):
    """paragraph binary equivalent (BAM + graph → alignment/counts JSON),
    scoring each graph orientation's reads in one single-graph fill on
    --device."""
    from .. import resolve_device
    from ..io.cram import open_alignment_reader as BamReader
    from ..pipeline.paragraph import Parameters, align_and_disambiguate
    from ..reads.extraction import extract_reads

    p = argparse.ArgumentParser("paragraph")
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--graph-spec", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-t", "--target-regions", default="")
    p.add_argument("-M", "--max-reads", type=int, default=10000)
    p.add_argument("--variant-min-reads", type=int, default=3)
    p.add_argument("--variant-min-frac", type=float, default=0.01)
    p.add_argument("--bad-align-frac", type=float, default=0.8)
    p.add_argument("--path-sequence-matching", action="store_true")
    p.add_argument("--graph-sequence-matching", default=True)
    p.add_argument("--validate", action="store_true",
                   help="validate alignments against truth paths encoded "
                        "in simulated read names (see docs/validation-"
                        "with-simulated-reads.md); runs the per-read "
                        "cascade on the host")
    p.add_argument("--validate-schemas", action="store_true",
                   help="JSON-Schema validation of the input graph and "
                        "the output JSON (paragraph_tpu_torch/schema/)")
    _add_device_arg(p)
    _add_logging_args(p)
    args = p.parse_args(argv)
    _setup_logging(args)
    device = resolve_device(args.device)

    parameters = Parameters(
        max_reads=args.max_reads,
        min_reads_for_variant=args.variant_min_reads,
        min_frac_for_variant=args.variant_min_frac,
        bad_align_frac=args.bad_align_frac,
        path_sequence_matching=args.path_sequence_matching,
        validate_alignments=args.validate,
    )
    parameters.load(_load_json(args.graph_spec), args.reference,
                    args.target_regions)
    reader = BamReader(args.bam, "", args.reference)
    reads = extract_reads(reader, parameters.target_regions,
                          parameters.max_reads,
                          parameters.longest_alt_insertion)
    if args.validate_schemas:
        from ..utils.schema import validate, validate_graph_input

        validate_graph_input(parameters.description)
    output = align_and_disambiguate(parameters, reads, device=device)
    output["bam"] = args.bam
    if args.validate_schemas:
        validate(output, "output")
    with _open_out(args.output) as f:
        json.dump(output, f, sort_keys=True, indent=2)
    return 0


def cmd_idxdepth(argv):
    """idxdepth equivalent."""
    from ..pipeline.idxdepth import estimate_depths

    p = argparse.ArgumentParser("idxdepth")
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-I", "--include-regex", default="")
    p.add_argument("--autosome-regex", default=r"(chr)?[1-9][0-9]?")
    p.add_argument("--sex-chromosome-regex", default=r"(chr)?[XY]")
    p.add_argument("--include-alt-contig", action="store_true")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--robust-depth", action="store_true",
                   help="also fit a MinCovDet robust Gaussian over the "
                        "sampled depths (outlier-resistant mean/variance "
                        "per contig)")
    args = p.parse_args(argv)
    out = estimate_depths(
        args.bam, args.reference, include_regex=args.include_regex,
        autosome_regex=args.autosome_regex,
        sex_chromosome_regex=args.sex_chromosome_regex,
        include_alt_contig=args.include_alt_contig, threads=args.threads,
        robust=args.robust_depth)
    with _open_out(args.output) as f:
        json.dump(out, f, sort_keys=True, indent=2)
    return 0


def cmd_vcf2paragraph(argv):
    """vcf2paragraph.py equivalent (VCF → one graph JSON)."""
    from ..graph.build import convert_vcf_records
    from ..io.vcf import VcfReader

    p = argparse.ArgumentParser("vcf2paragraph")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-r", "--reference-sequence", dest="reference",
                   required=True)
    p.add_argument("-g", "--graph-type", default="alleles",
                   choices=["alleles", "haplotypes"])
    p.add_argument("-p", "--read-length", type=int, default=150)
    p.add_argument("-l", "--max-ref-node-length", type=int, default=1000)
    p.add_argument("-T", "--target-region", action="append", default=None)
    p.add_argument("--ins-info-key", default="SEQ")
    p.add_argument("--alt-paths", action="store_true")
    p.add_argument("--alt-splitting", action="store_true")
    p.add_argument("--retrieve-reference-sequence", action="store_true")
    args = p.parse_args(argv)

    records = list(VcfReader(args.input))
    graph = convert_vcf_records(
        records, args.reference, ins_info_key=args.ins_info_key,
        target_regions=args.target_region,
        ref_node_padding=args.read_length,
        ref_node_max_length=args.max_ref_node_length,
        allele_graph=args.graph_type == "alleles",
        alt_paths=args.alt_paths, alt_splitting=args.alt_splitting)
    if args.retrieve_reference_sequence:
        from ..io.fasta import FastaFile
        from ..io.regions import parse_region

        fasta = FastaFile(args.reference)
        for n in graph.get("nodes", []):
            if "reference" in n:
                chrom, start, end = parse_region(n["reference"])
                n["reference_sequence"] = fasta.fetch(chrom, start - 1, end)
    with _open_out(args.output) as f:
        json.dump(graph, f, sort_keys=True, indent=4,
                  separators=(",", ": "))
    return 0


def cmd_graph_to_fasta(argv):
    """graph-to-fasta equivalent: emit every path sequence as a FASTA
    contig (for read simulation, main/graph-to-fasta.cpp)."""
    from ..graph.model import SequenceGraph

    p = argparse.ArgumentParser("graph-to-fasta")
    p.add_argument("-g", "--graph-spec", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--output", default="-")
    args = p.parse_args(argv)
    desc = _load_json(args.graph_spec)
    if "graph" in desc:
        desc = {**desc, **desc["graph"]}
    graph = SequenceGraph.from_json(desc, args.reference)
    with _open_out(args.output) as f:
        for path in desc.get("paths", []):
            node_ids = [graph.name_to_id[n] for n in path["nodes"]]
            seq = "".join(graph.node_seq(n) for n in node_ids)
            f.write(f">{path['path_id']}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + "\n")
    return 0


def cmd_kmerstats(argv):
    """kmerstats equivalent: kmer uniqueness statistics for a graph
    (main/kmerstats.cpp)."""
    from ..align.kmer_index import KmerIndex
    from ..graph.model import SequenceGraph

    p = argparse.ArgumentParser("kmerstats")
    p.add_argument("-g", "--graph-spec", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-k", "--kmer-length", type=int, default=16)
    p.add_argument("-o", "--output", default="-")
    args = p.parse_args(argv)
    desc = _load_json(args.graph_spec)
    graph = SequenceGraph.from_json(desc, args.reference)
    index = KmerIndex(graph, args.kmer_length)
    n_unique = sum(1 for paths in index.kmer_to_paths.values()
                   if len(paths) == 1)
    out = {
        "kmer_length": args.kmer_length,
        "kmers": len(index.kmer_to_paths),
        "unique_kmers": n_unique,
        "nodes": [
            {
                "name": graph.node_name(n),
                "unique_kmers": index.num_unique_kmers_overlapping_node(n),
            }
            for n in range(graph.num_nodes)
        ],
    }
    with _open_out(args.output) as f:
        json.dump(out, f, sort_keys=True, indent=2)
    return 0


def cmd_paragraph2dot(argv):
    """paragraph2dot.py equivalent: graph JSON → graphviz dot."""
    p = argparse.ArgumentParser("paragraph2dot")
    p.add_argument("graph")
    p.add_argument("output")
    args = p.parse_args(argv)
    desc = _load_json(args.graph)
    if "graph" in desc:
        desc = {**desc, **desc["graph"]}
    with _open_out(args.output) as f:
        f.write("digraph paragraph {\n")
        for node in desc.get("nodes", []):
            label = node["name"]
            if "sequence" in node:
                seq = node["sequence"]
                label += "\\n" + (seq if len(seq) <= 20 else
                                  seq[:8] + "..." + seq[-8:])
            elif "reference" in node:
                label += "\\n" + str(node["reference"])
            f.write(f'  "{node["name"]}" [label="{label}"];\n')
        for edge in desc.get("edges", []):
            attrs = ""
            if edge.get("sequences"):
                attrs = f' [label="{",".join(edge["sequences"])}"]'
            f.write(f'  "{edge["from"]}" -> "{edge["to"]}"{attrs};\n')
        f.write("}\n")
    return 0


def _tool(name):
    def run(argv):
        from . import tools

        return getattr(tools, name)(argv)

    return run


_COMMANDS = {
    "multigrmpy": cmd_multigrmpy,
    "grmpy": cmd_grmpy,
    "paragraph": cmd_paragraph,
    "idxdepth": cmd_idxdepth,
    "vcf2paragraph": cmd_vcf2paragraph,
    "graph-to-fasta": cmd_graph_to_fasta,
    "kmerstats": cmd_kmerstats,
    "paragraph2dot": cmd_paragraph2dot,
    "multiparagraph": _tool("cmd_multiparagraph"),
    "addVariants": _tool("cmd_add_variants"),
    "grmpy-vcf-merge": _tool("cmd_grmpy_vcf_merge"),
    "msa2vcf": _tool("cmd_msa2vcf"),
    "compare-alignments": _tool("cmd_compare_alignments"),
    "pam": _tool("cmd_pam"),
    "simulate-reads": _tool("cmd_simulate_reads"),
}


def main(argv=None):
    argv = _expand_response_files(
        list(sys.argv[1:] if argv is None else argv))
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: paragraph-tpu-torch <tool> [options]\n\ntools: "
              + ", ".join(sorted(_COMMANDS)))
        return 0
    tool = argv[0]
    if tool not in _COMMANDS:
        print(f"unknown tool: {tool}", file=sys.stderr)
        return 2
    return _COMMANDS[tool](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
