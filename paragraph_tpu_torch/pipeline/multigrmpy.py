"""End-to-end entry point: VCF/JSON events → graphs → genotyping → VCF.

Counterpart of ``run`` in ``paragraph_tpu/pipeline/multigrmpy.py`` (the
reference's multigrmpy.py), with the grmpy stage on the caller's device.
Options, VCF → graph conversion and ``vcfupdate`` are the JAX package's.
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Optional

from paragraph_tpu.genotyping.sample_info import load_manifest
from paragraph_tpu.pipeline.multigrmpy import (  # noqa: F401 (re-export)
    MultigrmpyOptions, load_graph_description)
from paragraph_tpu.pipeline.vcfupdate import read_grmpy, update_vcf_from_grmpy

from .. import resolve_device
from .grmpy import GrmpyParameters, run_grmpy


def run(options: MultigrmpyOptions, device="cuda",
        kernel_stats: Optional[dict] = None) -> dict:
    """multigrmpy run (multigrmpy.py:215-343) with scoring on `device`;
    returns the output paths. The scorers' stats are added into
    `kernel_stats` when given."""
    device = resolve_device(device)
    os.makedirs(options.output, exist_ok=True)
    graphs = load_graph_description(options)

    if options.validate_schemas:
        from paragraph_tpu.utils.schema import validate_graph_input

        for i, g in enumerate(graphs):
            try:
                validate_graph_input(g)
            except Exception as exc:
                raise type(exc)(f"event {i} ({g.get('ID', '?')}): {exc}")

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

    if options.validate_schemas:
        from paragraph_tpu.utils.schema import validate

        for i, rec in enumerate(results):
            try:
                validate(rec, "genotypes")
            except Exception as exc:
                raise type(exc)(f"genotypes record {i}: {exc}")

    genotypes_json = os.path.join(options.output, "genotypes.json.gz")
    with gzip.open(genotypes_json, "wt", compresslevel=2) as f:
        f.write(json.dumps(results, sort_keys=True, separators=(",", ":")))

    out = {"genotypes_json": genotypes_json}
    if options.input.endswith((".vcf", ".vcf.gz", ".bcf")):
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
