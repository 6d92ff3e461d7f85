"""The VCF to graph conversion of the port's pipeline/multigrmpy.py
(frozen copy: ``MultigrmpyOptions``, ``parse_vcf_lines``,
``convert_vcf_to_json``)."""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import List, Optional

from ..graph.build import convert_vcf_records
from ..io.regions import parse_region
from ..io.vcf import VcfReader


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

