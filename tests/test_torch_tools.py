"""The port's remaining tools and host library modules vs the JAX package.

Library modules (graph/intervals, graph/refmapping, graph/graph_json,
graph/path_families, align/qual_adjust, align/gapped, align/gapless,
pipeline/idxdepth): each side builds its own objects from the same
values (the inputs of the JAX package's own tests of those modules) and
the outputs must be equal, exactly.

The twelve subcommands the port took over with them (idxdepth,
vcf2paragraph, graph-to-fasta, kmerstats, paragraph2dot, multiparagraph,
addVariants, grmpy-vcf-merge, msa2vcf, compare-alignments, pam,
simulate-reads) run through each package's ``cli.main.main`` on the same
files, made by the repo's workload generator from a seed: the files they
write and what they print must be byte-equal. multiparagraph runs the
port with ``--device cpu`` (the plain PyTorch fill) and the files may
differ only in the ``engine`` marker that names the scoring engine.
"""
import gzip
import importlib
import json
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

PACKAGES = ("paragraph_tpu", "paragraph_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker while this module runs: workers
    with all-core torch pools starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mod(package, name):
    return importlib.import_module(f"{package}.{name}")


def _same_on_both(run, *args):
    """run(package, *args) on each package; the two results must be
    equal. Returns the port's."""
    jax_side, port_side = (run(p, *args) for p in PACKAGES)
    assert port_side == jax_side
    return port_side


def _graph(package, names, seqs, edges, labels=()):
    g = _mod(package, "graph.model").SequenceGraph(list(names), list(seqs))
    for f, t in edges:
        g.add_edge(f, t)
    for f, t, label in labels:
        g.add_label_to_edge(f, t, label)
    return g


def _lite_path(package, nodes, start, end):
    return _mod(package, "pipeline.haplotypes").LitePath(nodes, start, end)


# --------------------------------------------------------- graph/intervals


def _interval_queries(package, case):
    ib = _mod(package, "graph.intervals").IntervalBuffer()
    if case == "fixed":  # IntervalBufferTest.cpp::TestIntervalBuffer
        for s, e, lane in [(10, 20, 0), (12, 30, 0), (10, 30, 1),
                           (32, 35, 1), (36, 37, 1), (38, 40, 1),
                           (42, 45, 1)]:
            ib.add_interval(s, e, lane)
        queries = [(15, 16), (15, 21), (11, 21), (11, 31), (8, 15),
                   (8, 9), (32, 39), (32, 43), (30, 30), (10, 11)]
        out = []
        for advance in (None, 30):
            if advance is not None:
                ib.advance(advance)
            out.append([(ib.is_covered(s, e, lane), ib.has_overlap(s, e,
                                                                  lane))
                        for s, e in queries for lane in (0, 1)])
        return out + [ib.get_intervals(0), ib.get_intervals(1)]
    rng = random.Random(case)
    ivs = []
    for _ in range(20):
        start = rng.randrange(512)
        ivs.append((start, min(start + rng.randrange(100), 511)))
    for s, e in sorted(ivs):
        ib.add_interval(s, e, 2)
    out = []
    for _ in range(512):
        start = rng.randrange(512)
        end = min(start + rng.randrange(50), 511)
        out.append((ib.is_covered(start, end, 2),
                    ib.has_overlap(start, end, 2)))
    ib.advance(256)
    return out + [ib.get_intervals(2)]


@pytest.mark.parametrize("case", ["fixed", 1234, 77])
def test_interval_buffer(case):
    assert _same_on_both(_interval_queries, case)


# -------------------------------------------------------- graph/refmapping


def _swap_graph(package, left, del_seq, ins_seq, right):
    return _graph(package, ["LF", "DEL", "INS", "RF"],
                  [left, del_seq, ins_seq, right],
                  [(0, 1), (0, 2), (1, 3), (2, 3)])


def _refmapping(package, case):
    rm = _mod(package, "graph.refmapping")
    if case == "positions":  # Mapping_MapsNodeCoordinates
        g = _swap_graph(package, "AAAA", "C", "T", "GGGG")
    else:  # Mapping_MapsPaths
        g = _swap_graph(package, "AAAA", "CA", "TC", "GGGG")
    mapping = rm.GraphReferenceMapping(g)
    mapping.add_mapping(_lite_path(package, [0, 1, 3], 0, 3), "chr1", 10)
    mapping.add_mapping(_lite_path(package, [0, 2, 3], 0, 3), "chr2", 20)
    if case == "positions":
        return [sorted(tuple(p) for p in mapping.map_position(n, o))
                for n in range(4) for o in range(len(g.node_seq(n)))]
    queries = [([0, 1, 3], 2, 1), ([0, 2, 3], 0, 3), ([1, 3], 0, 2),
               ([0], 1, 3), ([2, 3], 1, 0)]
    return [sorted((enc, tuple(iv)) for enc, iv in mapping.map_path(
        _lite_path(package, *q))) for q in queries]


@pytest.mark.parametrize("case", ["positions", "paths"])
def test_graph_reference_mapping(case):
    assert any(_same_on_both(_refmapping, case))


# -------------------------------------------------------- graph/graph_json


def _graph_json(package, case, tmp_path):
    gj = _mod(package, "graph.graph_json")
    g = _swap_graph(package, "AAAA", "C", "T", "GGGG")
    g.add_label_to_edge(0, 1, "REF")
    g.add_label_to_edge(0, 2, "ALT")
    g.add_label_to_edge(0, 2, "ALT2")
    desc = gj.graph_to_json(g)
    if case == "parse":
        back = gj.parse_graph(desc)
    else:
        path = tmp_path / f"{package}.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump({"graph": desc}, f)
        back = gj.load_graph(str(path))
    return desc, gj.graph_to_json(back), sorted(back.edges())


@pytest.mark.parametrize("case", ["parse", "load_gz"])
def test_graph_json(case, tmp_path):
    desc, again, edges = _same_on_both(_graph_json, case, tmp_path)
    assert desc == again and len(edges) == 4


# ----------------------------------------------------- graph/path_families

_DOUBLE_SWAP = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (3, 5), (4, 6),
                (5, 6)]
_HOURGLASS = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (4, 5), (4, 6),
              (5, 7), (6, 7)]
FAMILY_CASES = {
    "disjoint": ("AAA CCCC GGG AAAA TTTT GG AA", _DOUBLE_SWAP,
                 {(0, 1), (1, 3), (5, 6)}),
    "long_path": ("AAA CCCC GGG AAAA TTTT GG AA", _DOUBLE_SWAP,
                  {(0, 1), (1, 3), (3, 4), (4, 6)}),
    "multiple_extensions": ("AAA CCCC GGG AAAA TTTT GG AA", _DOUBLE_SWAP,
                            {(1, 3), (2, 3), (3, 4), (3, 5), (4, 6),
                             (5, 6)}),
    "hourglass": ("N A A A A A A N", _HOURGLASS, {(3, 4)}),
}


def _path_families(package, case):
    pf = _mod(package, "graph.path_families")
    if case == "from_graph":
        g = _graph(package, [f"n{i}" for i in range(7)], "ACTAGCT",
                   _DOUBLE_SWAP, [(0, 1, "DEL"), (1, 3, "DEL"),
                                  (0, 2, "INS"), (3, 5, "INS")])
        fams = pf.get_path_families_from_graph(g)
        return ({k: sorted(v) for k, v in sorted(fams.items())},
                [sorted(pf.path_to_path_family(_lite_path(package, *p)))
                 for p in (([1, 3, 4], 0, 0), ([0, 2, 3, 5, 6], 1, 0))])
    seqs, edges, family = FAMILY_CASES[case]
    seqs = seqs.split()
    g = _graph(package, [f"n{i}" for i in range(len(seqs))], seqs, edges)
    paths, complete = pf.get_maximal_paths_for_family(g, family)
    return (complete, [(p.start, tuple(p.nodes), p.end) for p in paths],
            [pf.family_contains_path(family, p) for p in paths])


@pytest.mark.parametrize("case", sorted(FAMILY_CASES) + ["from_graph"])
def test_path_families(case):
    assert _same_on_both(_path_families, case)


# ------------------------------------------------------- align/qual_adjust

_MATRIX = np.array([[1, -4, -4, -4], [-4, 1, -4, -4],
                    [-4, -4, 1, -4], [-4, -4, -4, 1]])


def _qual_adjust(package, case):
    qa = _mod(package, "align.qual_adjust")
    if case == "log_base":
        freqs = np.array([0.3, 0.2, 0.2, 0.3])
        return (qa.recover_log_base(_MATRIX, freqs), qa.score_gcf(_MATRIX),
                qa.score_gcf(2 * _MATRIX))
    if case == "adjusted":
        return qa.adjusted_qual_matrix(60, _MATRIX,
                                       np.full(4, 0.25)).tolist()
    mat, go, ge = qa.dna_scaled_adjusted_qual_matrix(*case)
    return np.asarray(mat).tolist(), go, ge


@pytest.mark.parametrize("case", [
    # (max_score, max_qual, gap_open, gap_extend, match, mismatch, gc)
    (32, 40, 6, 1, 1, 4, 0.5),
    (64, 40, 6, 1, 1, 4, 0.4),
    (32, 33, 5, 2, 2, 6, 0.6),
    "log_base", "adjusted"], ids=str)
def test_qual_adjust(case):
    assert _same_on_both(_qual_adjust, case)


# ------------------------------------------------- align/gapped, gapless


def _alignment_key(ga):
    return (list(ga.node_ids), ga.path_start, ga.path_end,
            ga.generate_cigar())


_BRANCH = (["LF", "DEL", "INS", "RF"], ["ATATTA", "CGCG", "TTTT",
                                        "TATTTGGAACC"],
           [(0, 1), (0, 2), (1, 3), (2, 3), (0, 3)])
_TWO_BRANCHES = (["LF", "B1", "B2", "RF"], ["ATCGA", "TT", "TT", "GGCAT"],
                 [(0, 1), (0, 2), (1, 3), (2, 3)])
_CHAIN = (["A", "B", "C"], ["AAG", "CGGT", "CTT"], [(0, 1), (1, 2)])


def _gapped(package, case):
    ga = _mod(package, "align.gapped")
    if case == "pinned":
        prefix = ga.PinnedAligner(1, -1, -2).prefix_align("TGCTTTTAA",
                                                          "TAACTTTTGGG")
        suffix = ga.PinnedAligner(5, -4, -8).suffix_align("TACGAGAG",
                                                          "TCACGGAGA")
        return [(start, list(ops)) for start, ops in (prefix, suffix)]
    if case == "extensions":
        g = _graph(package, *_BRANCH)
        starts = ga.extend_path_start(g, ((3,), 0, 2), 5)
        ends = ga.extend_path_end(g, ((0,), 0, 5), 2)
        return [sorted((p, ga.path_seq(g, p)) for p in ps)
                for ps in (starts, ends)]
    graph, kwargs, queries = {
        "branch": (_BRANCH, dict(kmer_len=4, padding_len=2),
                   ["ATTACGCGTAT", "TATTATATTT", "ATTATTTTTATTTG"]),
        "deletion_gap": (_BRANCH, dict(kmer_len=4, padding_len=4, match=1,
                                       mismatch=-1, gap=-2),
                         ["ATTACGTATTT", "ATATTACGCGTTGGAACC"]),
        "soft_clips": (_CHAIN, dict(kmer_len=4, padding_len=0),
                       ["TTCGGT", "CGGTAA"]),
        "multimapping": (_TWO_BRANCHES, dict(kmer_len=4, padding_len=0),
                         ["TCGATTGGC"]),
    }[case]
    aligner = ga.GappedGraphAligner(_graph(package, *graph), **kwargs)
    return [sorted(_alignment_key(a) for a in aligner.align(q))
            for q in queries]


@pytest.mark.parametrize("case", ["pinned", "extensions", "branch",
                                  "deletion_gap", "soft_clips",
                                  "multimapping"])
def test_gapped_aligner(case):
    assert any(_same_on_both(_gapped, case))


_DELETION = (["LF", "MID", "RF"], ["AAAACC", "TTTGG", "ATTT"],
             [(0, 1), (0, 2), (1, 2)])


def _gapless(package, case):
    gl = _mod(package, "align.gapless")
    if case == "linear":
        pairs = [(4, "NNNNATCGTTTG", "AGGTTTTG"), (0, "VVVVV", "AATTC"),
                 (2, "ACGTRYKMAC", "AGGTAAGA")]
        nas = [gl.align_without_gaps(*p) for p in pairs]
        return [(na.reference_start, na.generate_cigar()) for na in nas] + [
            gl.extract_kmers_from_all_positions("AAATTTGC", k)
            for k in (3, 4, 9)]
    if case == "short_path":
        g = _graph(package, ["LF", "MID", "RF"], ["AAACC", "TTGGG", "TTAAA"],
                   _DELETION[2])
        return [sorted(_alignment_key(a)
                       for a in gl.get_best_alignment_to_short_path(
                           g, path, offset, query))
                for path, offset, query in [(((0,), 4, 4), 1, "CCTTA"),
                                            (((1,), 0, 4), 0, "TTGGGTT")]]
    g = _graph(package, *_DELETION)
    if case == "paths":
        return [_alignment_key(gl.align_path_without_gaps(g, path, q))
                for path, q in [(((1,), 1, 4), "ATGC"),
                                (((0, 1, 2), 2, 1), "TTCCTTAGGAT"),
                                (((0, 2), 3, 2), "ACCATT")]]
    if case == "aligner":
        aligner = gl.GaplessAligner(g, 3)
        return [sorted(_alignment_key(a) for a in aligner.align(q))
                for q in ("TTCCTTAGGAT", "AAACCATTT", "CCAAATGG")]
    index = _mod(package, "align.kmer_index").KmerIndex(g, 4)
    return [(gl.count_kmer_matches(index, s),
             gl.check_if_forward_oriented(index, s))
            for s in ("AAAA", "AAAACC", "GGTTTT", "AAATTTGGATT")]


@pytest.mark.parametrize("case", ["linear", "short_path", "paths",
                                  "aligner", "orientation"])
def test_gapless_aligner(case):
    assert any(_same_on_both(_gapless, case))


# ------------------------------------------------------ pipeline/idxdepth


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """Four events (two deletions, two insertions), 10x, one sample."""
    from make_workload import generate

    wl = tmp_path_factory.mktemp("wl_tools")
    truth = generate(str(wl), n_events=4, depth=10, seed=7,
                     kinds=("DEL", "INS"))
    return wl, truth


@pytest.fixture(scope="module")
def uniform_bams(tmp_path_factory):
    """test_idxdepth_parity.py's fixtures: a contig tiled at exactly 10x
    by 100-base reads, and one of mixed read lengths (80 and 100)."""
    from make_workload import bam_record, write_bam

    out = tmp_path_factory.mktemp("idxdepth_bams")
    rng = random.Random(5)
    made = {}
    for name, contig, length, step, read_lens in [
            ("uniform", "chr1", 20000, 10, (100,)),
            ("mixed", "chr2", 5000, 40, (80, 100, 100))]:
        seq = "".join(rng.choice("ACGT") for _ in range(length))
        ref = out / f"{name}.fa"
        ref.write_text(f">{contig}\n" + "".join(
            seq[i:i + 60] + "\n" for i in range(0, length, 60)))
        recs = []
        for i, start in enumerate(range(0, length - 100, step)):
            n = read_lens[i % len(read_lens)]
            recs.append(bam_record(f"r{i}", 0, 0, start + 1, 60, [(0, n)],
                                   -1, -1, 0, seq[start:start + n],
                                   chr(63) * n))
        bam = out / f"{name}.bam"
        write_bam(str(bam), contig, length, recs)
        made[name] = (str(bam), str(ref))
    return made


def _depths(package, bam, ref, kwargs):
    return _mod(package, "pipeline.idxdepth").estimate_depths(bam, ref,
                                                              **kwargs)


@pytest.mark.parametrize("case,kwargs", [
    ("uniform", {}),
    ("uniform", {"robust": True, "include_regex": "chr1"}),
    ("mixed", {"autosome_regex": "chr2"}),
    ("workload", {"autosome_regex": "chrS"}),
    ("workload", {"sex_chromosome_regex": "chrS", "threads": 2}),
], ids=["uniform", "uniform_robust", "mixed_lengths", "workload",
        "workload_sex"])
def test_idxdepth(case, kwargs, uniform_bams, workload):
    if case == "workload":
        wl = workload[0]
        bam, ref = str(wl / "sample.bam"), str(wl / "ref.fa")
    else:
        bam, ref = uniform_bams[case]
    out = _same_on_both(_depths, bam, ref, kwargs)
    assert out["contigs"] and out["contigs"][0]["depth"] > 0


# ------------------------------------------------------------ subcommands


def multiparagraph_events(truth, contig="chrS"):
    """multiparagraph's event list for the workload's planted events, in
    the reference tool's convention: deleted bases start..end; an
    insertion after base `pos` has end = start - 1 and its sequence."""
    events = []
    for ev in truth:
        if ev["kind"] == "DEL":
            events.append({"chrom": contig, "start": ev["pos"] + 1,
                           "end": ev["pos"] + ev["size"]})
        elif ev["kind"] == "INS":
            events.append({"chrom": contig, "start": ev["pos"] + 1,
                           "end": ev["pos"], "ins": ev["ins_seq"]})
    return events


def _fixed_grmpy_results(vcf, samples, seed):
    """Genotyping results for every record of `vcf`, made from a seed in
    the shape grmpy writes them (matched to the records by GRMPY_ID)."""
    rng = random.Random(seed)
    results = []
    for line in open(vcf):
        if line.startswith("#"):
            continue
        vid = line.split("\t")[2]
        per_sample = {}
        for s in samples:
            gt = rng.choice(["REF/REF", "REF/ALT", "ALT/ALT"])
            per_sample[s] = {
                "gt": {"GT": gt, "num_reads": rng.randint(0, 40),
                       "filters": rng.choice([[], ["BP_DEPTH"]]),
                       "GL": {g: -rng.random() * 30 for g in
                              ("REF/REF", "REF/ALT", "ALT/ALT")}},
                "alleles": {a: {"num_fwd_reads": rng.randint(0, 20),
                                "num_rev_reads": rng.randint(0, 20)}
                            for a in ("REF", "ALT")}}
        results.append({"graphinfo": {"ID": vid}, "samples": per_sample})
    return results


@pytest.fixture(scope="module")
def tool_inputs(workload, tmp_path_factory):
    """The shared input files of the subcommand cases."""
    from paragraph_tpu_torch.graph.build import convert_vcf_records
    from paragraph_tpu_torch.io.vcf import VcfReader
    from paragraph_tpu_torch.pipeline import vcfupdate

    wl, truth = workload
    d = tmp_path_factory.mktemp("tool_inputs")
    ref = str(wl / "ref.fa")
    vcf = str(wl / "candidates.vcf")
    records = list(VcfReader(vcf))
    for name, kwargs in [("alt_paths", dict(alt_paths=True)),
                         ("plain", {})]:
        graph = convert_vcf_records(records[:1], ref, **kwargs)
        (d / f"graph_{name}.json").write_text(json.dumps(graph))
    node = next(n for n in graph["nodes"] if "reference" in n)
    (d / "variants.json").write_text(json.dumps({"variants": {
        node["name"]: [{"start": 10, "end": 10, "alt": "T"},
                       {"start": 20, "end": 19, "alt": "AC"},
                       {"start": 30, "end": 32, "alt": ""}]}}))
    (d / "events.json").write_text(json.dumps(multiparagraph_events(truth)))

    # per-sample genotype VCFs written by the port's vcfupdate; sample B
    # misses the last record, so the merge fills its columns
    lines = open(vcf).read().splitlines()
    body = [ln for ln in lines if not ln.startswith("#")]
    with_ids = [ln for ln in lines if ln.startswith("#")] + [
        "\t".join(f[:7] + [f"GRMPY_ID={f[2]}"])
        for f in (ln.split("\t") for ln in body)]
    for sample, keep in (("A", len(body)), ("B", len(body) - 1)):
        src = d / f"in_{sample}.vcf"
        src.write_text("\n".join(with_ids[:len(with_ids) - len(body)
                                          + keep]) + "\n")
        results = _fixed_grmpy_results(str(src), [sample], seed=ord(sample))
        vcfupdate.update_vcf_from_grmpy(
            str(src), vcfupdate.read_grmpy(results),
            str(d / f"genotypes_{sample}.vcf"), [sample])

    rng = random.Random(3)
    ref_row = "".join(rng.choice("ACGT") for _ in range(60))
    rows = [ref_row, ref_row[:12] + "---" + ref_row[15:],
            ref_row[:30] + "G" + ref_row[31:],
            ref_row[:40] + "TTA" + ref_row[43:]]
    (d / "msa.fa").write_text("".join(
        f">s{i} row {i}\n{row[:30]}\n{row[30:]}\n"
        for i, row in enumerate(rows)))
    (d / "msa_ins.fa").write_text(">ref\nACGT--ACGTAC\n>alt\nACGTTTACG-AC\n")

    aln = [{"fragmentId": f"f{i}", "chromId": 0, "pos": 100 + i,
            "graphCigar": f"0[{50 + i}M]", "graphMapq": 60}
           for i in range(4)]
    changed = [dict(a, graphMapq=0) if i == 1 else a
               for i, a in enumerate(aln)] + [dict(aln[0])]
    (d / "aln1.json").write_text(json.dumps({"alignments": aln}))
    (d / "aln2.json").write_text(json.dumps({"alignments": changed}))

    regions = [f"chrS:{ev['pos'] - 200}-{ev['pos'] + 200}" for ev in truth]
    (d / "depth.json").write_text(json.dumps(
        {"regions": regions + ["chrZ:1-100"]}))
    return wl, d


def _subcommand_args(name, wl, d):
    """(argv with {out} for the output file, extra argv for the port)."""
    ref, bam = str(wl / "ref.fa"), str(wl / "sample.bam")
    graph, plain = str(d / "graph_alt_paths.json"), str(d / "graph_plain.json")
    return {
        "idxdepth": (["-b", bam, "-r", ref, "-o", "{out}",
                      "--autosome-regex", "chrS"], []),
        "vcf2paragraph": ([str(wl / "candidates.vcf"), "{out}", "-r", ref,
                           "--alt-paths", "-p", "120", "-l", "400"], []),
        "graph-to-fasta": (["-g", graph, "-r", ref, "-o", "{out}"], []),
        "kmerstats": (["-g", graph, "-r", ref, "-k", "12", "-o", "{out}"],
                      []),
        "paragraph2dot": ([graph, "{out}"], []),
        "multiparagraph": ([str(d / "events.json"), "-b", bam, "-r", ref,
                            "-o", "{out}", "--min-length", "10"],
                           ["--device", "cpu"]),
        "addVariants": ([plain, "{out}", "--variants",
                         str(d / "variants.json")], []),
        "grmpy-vcf-merge": (["-i", str(d / "genotypes_A.vcf"),
                             str(d / "genotypes_B.vcf"), "-o", "{out}"], []),
        "msa2vcf": ([str(d / "msa.fa"), "{out}", "--chrom", "chrM"], []),
        "compare-alignments": ([str(d / "aln1.json"), str(d / "aln2.json")],
                               []),
        "pam": (["-b", bam, "-g", str(d / "depth.json"), "-r", ref, "-o",
                 "{out}", "-M", "200"], []),
        "simulate-reads": (["-g", graph, "-r", ref, "-o", "{out}", "-l",
                            "60", "-d", "3", "-e", "0.02", "--seed", "5"],
                           []),
    }[name]


SUBCOMMANDS = ["addVariants", "compare-alignments", "graph-to-fasta",
               "grmpy-vcf-merge", "idxdepth", "kmerstats", "msa2vcf",
               "multiparagraph", "pam", "paragraph2dot", "simulate-reads",
               "vcf2paragraph"]


def _engine_blind(text):
    return re.sub(r'"engine": "[a-z]+"', '"engine": "-"', text)


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommand_output_equals_the_jax_package(name, tool_inputs,
                                                  tmp_path, capsys):
    wl, d = tool_inputs
    argv, port_extra = _subcommand_args(name, wl, d)
    written, printed = [], []
    for package in PACKAGES:
        out = str(tmp_path / f"{package}.out")
        args = [name] + [out if a == "{out}" else a for a in argv]
        if package == "paragraph_tpu_torch":
            args += port_extra
        assert _mod(package, "cli.main").main(args) == 0
        printed.append(capsys.readouterr().out)
        written.append(open(out).read() if "{out}" in argv else "")
    if name == "multiparagraph":
        events = json.loads(written[1])
        assert len(events) == 4 and all(
            e["graph"]["alignment_statistics"]["engine"] == "torch"
            for e in events)
        written = [_engine_blind(w) for w in written]
    assert written[1] == written[0]
    assert printed[1] == printed[0]
    assert written[1] or printed[1]


def test_port_lists_the_jax_packages_tools(capsys):
    listed = []
    for package in PACKAGES:
        assert _mod(package, "cli.main").main(["--help"]) == 0
        listed.append(capsys.readouterr().out.split("tools: ")[1].split(
            ", "))
    assert listed[1] == listed[0] and len(listed[1]) == 15


def test_multiparagraph_on_cuda_raises_without_a_card(tool_inputs, tmp_path,
                                                      monkeypatch):
    """No card: the port's multiparagraph refuses --device cuda (its
    default) instead of scoring on the CPU."""
    from paragraph_tpu_torch.cli.main import main

    wl, d = tool_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["multiparagraph", str(d / "events.json"), "-b",
              str(wl / "sample.bam"), "-r", str(wl / "ref.fa"), "-o",
              str(out)])
    assert not out.exists()
