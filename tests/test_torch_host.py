"""The port's copies of the host modules vs the JAX package's originals.

Each side builds its own objects from the same files and values: graph
JSON from VCF records (convert_vcf_records and the whole multigrmpy
conversion), reads extracted from the repo's BAM and CRAM fixtures,
breakpoint and combined genotypes from fixed counts, and the VCF that
vcfupdate writes from genotyping results. Host outputs: equality is
exact.
"""
import dataclasses
import gzip
import importlib
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

CRAM = os.path.join(os.path.dirname(__file__), "data", "cram")
PACKAGES = ("paragraph_tpu", "paragraph_tpu_torch")


def _both(module: str):
    """(JAX package's module, port's module) of one relative name."""
    return tuple(importlib.import_module(f"{p}.{module}") for p in PACKAGES)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from make_workload import generate

    wl = str(tmp_path_factory.mktemp("wl_host"))
    generate(wl, n_events=8, depth=8, seed=11)
    return wl


@pytest.mark.parametrize("kwargs", [
    {"allele_graph": True, "alt_paths": True, "alt_splitting": True},
    {"allele_graph": False},
    {"allele_graph": True, "ref_node_padding": 40,
     "ref_node_max_length": 100, "simplify": False},
], ids=["alleles_alt_paths", "haplotypes", "short_ref_nodes"])
def test_graph_json_from_vcf_records(workload, kwargs):
    ref = os.path.join(workload, "ref.fa")
    graphs = []
    for build, vcf in zip(_both("graph.build"), _both("io.vcf")):
        records = list(vcf.VcfReader(os.path.join(workload,
                                                  "candidates.vcf")))
        graphs.append([json.dumps(build.convert_vcf_records(
            [r], ref, **kwargs), sort_keys=True) for r in records])
    assert graphs[0] == graphs[1] and len(graphs[0]) >= 8


@pytest.mark.parametrize("split_type", ["lines", "superloci"])
def test_multigrmpy_graph_descriptions(workload, tmp_path, split_type):
    out = []
    for package, mg in zip(PACKAGES, _both("pipeline.multigrmpy")):
        opts = mg.MultigrmpyOptions(
            input=os.path.join(workload, "candidates.vcf"),
            reference=os.path.join(workload, "ref.fa"),
            output=str(tmp_path / package), split_type=split_type)
        out.append(json.dumps(mg.load_graph_description(opts),
                              sort_keys=True))
        with gzip.open(tmp_path / package / "variants.vcf.gz", "rt") as f:
            out.append(f.read())
    assert out[0] == out[2] and out[1] == out[3]


def _reads(extraction, cram, path, regions):
    reader = cram.open_alignment_reader(path, "", "")
    reads = extraction.extract_reads(reader, regions, 10000, 300)
    return [r.to_json() for r in reads]


@pytest.mark.parametrize("name,regions", [
    ("sample.bam", None),
    ("chrX_noref.cram", ["chrX:1-9000"]),
    ("chrX_embed.cram", ["chrX:500-2500"]),
    ("deletion.cram", ["chrom:100-400"]),
])
def test_extracted_reads(workload, name, regions):
    path = os.path.join(workload if name.endswith(".bam") else CRAM, name)
    if regions is None:  # around the third planted event
        with open(os.path.join(workload, "truth.json")) as f:
            pos = json.load(f)[2]["pos"]
        with open(os.path.join(workload, "ref.fa")) as f:
            contig = f.readline()[1:].split()[0]
        regions = [f"{contig}:{pos - 300}-{pos + 300}"]
    got = [_reads(e, c, path, regions)
           for e, c in zip(_both("reads.extraction"), _both("io.cram"))]
    assert got[0] == got[1] and len(got[0]) > 0


@pytest.mark.parametrize("name", ["chrX_noref.cram", "deletion.cram"])
def test_cram_records(name):
    got = []
    for cram in _both("io.cram"):
        reader = cram.CramReader(os.path.join(CRAM, name),
                                 reference_path="")
        got.append([dataclasses.asdict(r) for r in reader.records()])
    assert got[0] == got[1] and len(got[0]) > 0


COUNTS = [[20, 0], [20, 20], [0, 20], [3, 1], [0, 0], [55, 2], [1, 40]]


@pytest.mark.parametrize("poisson", [False, True])
@pytest.mark.parametrize("alleles,ploidy,counts", [
    (["REF", "ALT"], 2, COUNTS),
    (["REF", "ALT"], 1, COUNTS),
    (["REF", "A1", "A2"], 2, [[10, 10, 0], [0, 5, 30], [2, 2, 2]]),
])
def test_breakpoint_genotypes(alleles, ploidy, counts, poisson):
    out = []
    for gt_mod, par in zip(_both("genotyping.breakpoint_genotyper"),
                           _both("genotyping.parameters")):
        genotyper = gt_mod.BreakpointGenotyper(
            par.GenotypingParameters(alleles, ploidy))
        p = gt_mod.BreakpointGenotyperParameter(40.0, 150, 20.0, poisson)
        out.append([json.dumps(genotyper.genotype(p, c).to_json(alleles),
                               sort_keys=True) for c in counts])
    assert out[0] == out[1]


@pytest.mark.parametrize("counts", [
    [[20, 20], [18, 22]], [[20, 20], [0, 30]], [[0, 0], [1, 1]],
    [[30, 0], [25, 2], [2, 40]]], ids=["agree", "conflict", "no_reads",
                                        "three"])
def test_combined_genotypes(counts):
    """Breakpoint genotypes from counts, combined into the event's
    genotype (by consensus, or by total counts when they conflict)."""
    out = []
    for genotype, combined, bp, par in zip(
            _both("genotyping.genotype"), _both("genotyping.combined"),
            _both("genotyping.breakpoint_genotyper"),
            _both("genotyping.parameters")):
        genotyper = bp.BreakpointGenotyper(
            par.GenotypingParameters(["REF", "ALT"], 2))
        p = bp.BreakpointGenotyperParameter(40.0, 150, 20.0, False)
        gs = genotype.GenotypeSet()
        for c in counts:
            gs.add(["REF", "ALT"], genotyper.genotype(p, c))
        out.append(json.dumps(combined.combined_genotype(
            gs, p, genotyper).to_json(["REF", "ALT"]), sort_keys=True))
    assert out[0] == out[1]


def test_vcfupdate_records(workload, tmp_path):
    """Both vcfupdate copies write the same VCF from the JAX package's
    genotyping results of the workload."""
    from paragraph_tpu.pipeline.multigrmpy import MultigrmpyOptions, run

    jax_out = tmp_path / "jax"
    run(MultigrmpyOptions(
        input=os.path.join(workload, "candidates.vcf"),
        manifest=os.path.join(workload, "samples.txt"),
        reference=os.path.join(workload, "ref.fa"), output=str(jax_out),
        threads=1))
    with gzip.open(jax_out / "genotypes.json.gz", "rt") as f:
        results = json.load(f)
    texts = []
    for package, vu in zip(PACKAGES, _both("pipeline.vcfupdate")):
        out = tmp_path / f"{package}.vcf.gz"
        vu.update_vcf_from_grmpy(str(jax_out / "variants.vcf.gz"),
                                 vu.read_grmpy(results), str(out),
                                 ["sample"])
        with gzip.open(out, "rt") as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    assert sum(1 for line in texts[1].splitlines()
               if not line.startswith("#")) >= 8
