"""End-to-end entry point: VCF/JSON events → graphs → genotyping → VCF.

Counterpart of ``paragraph_tpu/pipeline/multigrmpy.py`` (the reference's
multigrmpy.py plus the per-block conversion of ``grm.vcf2paragraph``),
with the grmpy stage on the caller's device. The options and the VCF →
graph conversion are copied unchanged.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
from dataclasses import dataclass
from typing import List, Optional

from .. import resolve_device
from ..genotyping.sample_info import load_manifest
from ..graph.build import convert_vcf_records
from ..graph.templates import make_graph
from ..io.regions import parse_region
from ..io.vcf import VcfReader, VcfWriter
from .grmpy import GrmpyParameters, run_grmpy
from .parallel_grmpy import log_stages, pipeline_stage
from .vcfupdate import read_grmpy, update_vcf_from_grmpy


@dataclass
class MultigrmpyOptions:
    """CLI defaults of multigrmpy.py (multigrmpy.py:117-212)."""

    input: str = ""
    manifest: str = ""
    reference: str = ""
    output: str = ""
    split_type: str = "lines"
    read_length: int = 150
    max_ref_node_length: int = 300
    retrieve_reference_sequence: bool = False
    graph_type: str = "alleles"
    ins_info_key: str = "SEQ"
    alt_splitting: bool = True
    genotyping_parameters: Optional[dict] = None
    max_reads_per_event: int = 0
    # 0 = auto (hardware concurrency), mirroring the reference's
    # multiprocessing.cpu_count() default (multigrmpy.py:142)
    threads: int = 0
    path_sequence_matching: bool = False
    graph_sequence_matching: bool = True
    klib_sequence_matching: bool = False
    kmer_sequence_matching: bool = False
    bad_align_uniq_kmer_len: int = 0
    write_alignments: bool = False
    infer_read_haplotypes: bool = False
    # JSON-Schema enforcement (paragraph_tpu_torch/schema/*.json):
    # validate every event graph after conversion and every genotyping
    # record before writing; violations raise SchemaError with the JSON
    # path
    validate_schemas: bool = False
    # "host" = float64 parity engines; "device" = the float32 device
    # engine on the run's device (genotyping/device_engine.py); "auto" =
    # device for >= 4 samples and >= 8 events
    gt_engine: str = "auto"


def _file_sha256(path: str) -> str:
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        for buf in iter(lambda: f.read(1 << 16), b""):
            sha.update(buf)
    return sha.hexdigest()


_GRMPY_ID_HEADER = (
    '##INFO=<ID=GRMPY_ID,Number=1,Type=String,Description="Graph ID '
    'for linking to genotypes.json.gz; matches record.graphinfo.ID '
    'in there.">')


def parse_vcf_lines(vcf_path: str, read_length: int = 150,
                    split_type: str = "full"):
    """Group a VCF's records into event blocks and stamp each record's
    GRMPY_ID = ``basename@sha256:block``.

    Split strategies: ``full`` (everything in one block, id suffix 0),
    ``lines`` (one block per record), ``by_id`` (consecutive records
    sharing a VCF ID form one block), ``superloci`` (records within one
    read length of the previous record's span merge into one locus).
    Returns (header_lines, samples, blocks, block_ids).
    """
    vcf_id = os.path.basename(vcf_path) + "@" + _file_sha256(vcf_path)

    # the block chain carries a little state between records; each
    # strategy decides only whether the next record opens a new block
    state = {"id": None, "chrom": None, "end": None}

    def opens_block(record) -> bool:
        if split_type == "full":
            return not blocks
        if split_type == "lines":
            return True
        if split_type == "by_id":
            fresh = not record.id or record.id != state["id"]
            state["id"] = record.id or None
            return fresh
        if split_type == "superloci":
            fresh = (state["chrom"] != record.chrom or state["end"] is None
                     or record.pos > state["end"] + read_length)
            state["chrom"] = record.chrom
            state["end"] = max(record.stop or 0, record.pos)
            return fresh
        raise ValueError(f"Unknown VCF splitting type: {split_type}")

    reader = VcfReader(vcf_path)
    header_lines = list(reader.header_lines)
    if not any("##INFO=<ID=GRMPY_ID," in l for l in header_lines):
        header_lines.append(_GRMPY_ID_HEADER)

    blocks: List[List] = []
    block_ids: List[str] = []
    for record in reader:
        if record.pos < read_length:
            raise ValueError(
                f"record at {record.chrom}:{record.pos} is closer to the "
                "contig start than one read length")
        if opens_block(record):
            suffix = 0 if split_type == "full" else len(blocks) + 1
            block_ids.append(f"{vcf_id}:{suffix}")
            blocks.append([record])
        else:
            blocks[-1].append(record)
        record.info["GRMPY_ID"] = block_ids[-1]
    reader.close()
    return header_lines, reader.samples, blocks, block_ids


def convert_vcf_to_json(options: MultigrmpyOptions, alt_paths: bool = False):
    """convert_vcf_to_json (vcf2paragraph/__init__.py:117-170)."""
    header_lines, samples, records, block_ids = parse_vcf_lines(
        options.input, options.read_length, options.split_type)
    variants = []
    for record_block, block_id in zip(records, block_ids):
        graph = convert_vcf_records(
            record_block,
            options.reference,
            ins_info_key=options.ins_info_key,
            target_regions=None,
            ref_node_padding=options.read_length,
            ref_node_max_length=options.max_ref_node_length,
            allele_graph=options.graph_type == "alleles",
            simplify=True,
            alt_paths=alt_paths,
            alt_splitting=options.alt_splitting)
        result = {"graph": graph}
        chrom = None
        start = None
        end = None
        for tr in graph["target_regions"]:
            c, s, e = parse_region(tr)
            if chrom is None:
                chrom = c
            else:
                assert chrom == c
            start = s if start is None else min(start, s)
            end = e if end is None else max(end, e)
        result["chrom"] = chrom
        result["start"] = start
        result["end"] = end
        result["ID"] = block_id
        if options.retrieve_reference_sequence:
            from ..io.fasta import FastaFile

            fasta = FastaFile(options.reference)
            for n in result["graph"]["nodes"]:
                if "reference" in n:
                    c, s, e = parse_region(n["reference"])
                    n["reference_sequence"] = fasta.fetch(
                        c, s - 1, e).upper()
        variants.append(result)
    return header_lines, samples, records, variants


def load_graph_description(options: MultigrmpyOptions):
    """load_graph_description (multigrmpy.py:39-114): returns the list of
    per-event graph dicts (each carrying an ID)."""
    ext = os.path.splitext(options.input)[1]
    if ext == ".gz":
        ext = os.path.splitext(os.path.splitext(options.input)[0])[1] + ".gz"

    event_graphs = []
    if ext in (".vcf", ".vcf.gz", ".bcf"):
        header_lines, samples, records, event_list = convert_vcf_to_json(
            options, alt_paths=True)

        os.makedirs(options.output, exist_ok=True)
        variants_vcf = os.path.join(options.output, "variants.vcf.gz")
        writer = VcfWriter(variants_vcf, header_lines, samples)
        for block in records:
            for record in block:
                writer.write(record)
        writer.close()

        variants_json = os.path.join(options.output, "variants.json.gz")
        with gzip.open(variants_json, "wt", compresslevel=2) as f:
            # compact dump: the C encoder is ~8x the indented Python
            # encoder, and this file is parsed, not read, downstream
            f.write(json.dumps(event_list, sort_keys=True,
                               separators=(",", ":")))
    elif ext in (".json", ".json.gz"):
        opener = gzip.open if ext.endswith(".gz") else open
        with opener(options.input, "rt") as f:
            event_list = json.load(f)
        for event in event_list:
            if "graph" not in event:
                if "nodes" not in event and "edges" not in event:
                    event["type"], event["graph"] = make_graph(
                        options.reference, event)
    else:
        raise ValueError(
            f"Unknown input file extension {ext} for {options.input}")

    graph_id = 0
    for event in event_list:
        if "graph" in event:
            graph = event["graph"]
            if not graph.get("ID"):
                if "ID" in event:
                    graph["ID"] = event["ID"]
                else:
                    graph["ID"] = (os.path.basename(options.input) + ":"
                                   + str(graph_id))
            graph_id += 1
            event_graphs.append(graph)
        else:
            event_graphs.append(event)
    return event_graphs


def run(options: MultigrmpyOptions, device="cuda",
        kernel_stats: Optional[dict] = None) -> dict:
    """multigrmpy run (multigrmpy.py:215-343) with scoring on `device`;
    returns the output paths. The scorers' stats are added into
    `kernel_stats` when given, and the seconds of the job's stages into
    its `stage_s`: ``load`` (the graph description, the manifest and
    the input's schema checks), the pipeline's stages where the
    pipelined path runs, ``write_json`` (the output's schema checks
    included) and ``vcf_update``."""
    from ..utils.profiling import maybe_profile

    device = resolve_device(device)
    stats = {} if kernel_stats is None else kernel_stats
    with maybe_profile("grmpy"):
        out = _run_job(options, device, stats)
    log_stages(stats)
    return out


def _run_job(options: MultigrmpyOptions, device, kernel_stats: dict
             ) -> dict:
    with pipeline_stage(kernel_stats, "load"):
        os.makedirs(options.output, exist_ok=True)
        graphs = load_graph_description(options)

        if options.validate_schemas:
            from ..utils.schema import validate_graph_input

            for i, g in enumerate(graphs):
                try:
                    validate_graph_input(g)
                except Exception as exc:
                    raise type(exc)(
                        f"event {i} ({g.get('ID', '?')}): {exc}")

        manifest = load_manifest(options.manifest)
    parameters = GrmpyParameters(
        threads=options.threads,
        max_reads=options.max_reads_per_event or 10000,
        path_sequence_matching=options.path_sequence_matching,
        graph_sequence_matching=options.graph_sequence_matching,
        klib_sequence_matching=options.klib_sequence_matching,
        kmer_sequence_matching=options.kmer_sequence_matching,
        bad_align_uniq_kmer_len=options.bad_align_uniq_kmer_len,
        infer_read_haplotypes=options.infer_read_haplotypes,
        gt_engine=options.gt_engine,
    )
    if options.write_alignments:
        alignment_dir = os.path.join(options.output, "alignments")
        os.makedirs(alignment_dir, exist_ok=True)
        parameters.alignment_output_folder = alignment_dir

    results = run_grmpy(graphs, options.reference, manifest,
                        options.genotyping_parameters, parameters,
                        device=device, kernel_stats=kernel_stats)

    with pipeline_stage(kernel_stats, "write_json"):
        if options.validate_schemas:
            from ..utils.schema import validate

            for i, rec in enumerate(results):
                try:
                    validate(rec, "genotypes")
                except Exception as exc:
                    raise type(exc)(f"genotypes record {i}: {exc}")

        genotypes_json = os.path.join(options.output, "genotypes.json.gz")
        with gzip.open(genotypes_json, "wt", compresslevel=2) as f:
            f.write(json.dumps(results, sort_keys=True,
                               separators=(",", ":")))

    out = {"genotypes_json": genotypes_json}
    if options.input.endswith((".vcf", ".vcf.gz", ".bcf")):
        with pipeline_stage(kernel_stats, "vcf_update"):
            sample_names = [s.sample_name for s in manifest]
            grmpy_output = read_grmpy(results)
            genotypes_vcf = os.path.join(options.output, "genotypes.vcf.gz")
            vcf_input = os.path.join(options.output, "variants.vcf.gz")
            if not os.path.isfile(vcf_input):
                vcf_input = options.input
            update_vcf_from_grmpy(vcf_input, grmpy_output, genotypes_vcf,
                                  sample_names)
        out["genotypes_vcf"] = genotypes_vcf
    return out
