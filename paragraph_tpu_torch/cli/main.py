"""Command-line tools of the PyTorch / CUDA port: multigrmpy, grmpy and
paragraph.

The options are those of ``python -m paragraph_tpu.cli.main`` plus
``--device {cuda,cpu}`` (default cuda). Invoke as
``python -m paragraph_tpu_torch.cli.main <tool> [options]`` or through
the ``paragraph-tpu-torch`` console script.
"""
from __future__ import annotations

import argparse
import json
import sys

from paragraph_tpu.cli.main import (_add_logging_args, _expand_response_files,
                                    _load_json, _open_out, _setup_logging)


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
                        "genotyping records (paragraph_tpu/schema/)")
    p.add_argument("--genotyping-engine", default="auto",
                   choices=["auto", "host", "device"],
                   help="auto (default): host, or device for >=4 samples "
                        "and >=8 events; the device engine is not ported "
                        "yet, so a run that selects it stops with an error")
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
    from paragraph_tpu.genotyping.sample_info import load_manifest

    from ..pipeline.grmpy import GrmpyParameters, run_grmpy

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
    results = run_grmpy(graphs, args.reference, manifest, gt_params,
                        parameters, device=args.device)
    with _open_out(args.output_file) as f:
        json.dump(results, f, sort_keys=True, indent=2)
    return 0


def cmd_paragraph(argv):
    """paragraph binary equivalent (BAM + graph → alignment/counts JSON),
    scoring each graph orientation's reads in one single-graph fill on
    --device."""
    from paragraph_tpu.io.cram import open_alignment_reader as BamReader
    from paragraph_tpu.reads.extraction import extract_reads

    from .. import resolve_device
    from ..pipeline.paragraph import Parameters, align_and_disambiguate

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
                        "the output JSON (paragraph_tpu/schema/)")
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
        from paragraph_tpu.utils.schema import validate, validate_graph_input

        validate_graph_input(parameters.description)
    output = align_and_disambiguate(parameters, reads, device=device)
    output["bam"] = args.bam
    if args.validate_schemas:
        validate(output, "output")
    with _open_out(args.output) as f:
        json.dump(output, f, sort_keys=True, indent=2)
    return 0


_COMMANDS = {
    "multigrmpy": cmd_multigrmpy,
    "grmpy": cmd_grmpy,
    "paragraph": cmd_paragraph,
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
