"""Update a VCF with grmpy genotyping results → final genotypes VCF.

Equivalent of the reference's ``grm.vcfgraph.vcfupdate``
(the reference's src/python/lib/grm/vcfgraph/vcfupdate.py): header
augmentation (FORMAT GT/FT/DP/AD/ADF/ADR/PL (+OLD_GT), INFO GRMPY_ID,
FILTER lines), record matching by GRMPY_ID (fallback: allele sequence
names), per-sample FORMAT fill, and PL computation as
round(−10·lnGL) normalised by the minimum.

The htslib FORMAT-string resize behaviour (a later, longer FT assignment
replaces earlier stored strings with '.' runs — visible in the reference's
committed round-trip oracle) is reproduced via FormatStringMatrix. Sample
ordering is deterministic here (VCF samples then manifest order) where the
reference depended on python set iteration order.
"""
from __future__ import annotations

import gzip
import json
from collections import defaultdict
from typing import Dict, List, Optional

from ..graph.build import generate_allele_ids, generate_variant_id
from ..io.vcf import FormatStringMatrix, VcfReader, VcfRecord, VcfWriter


def make_pl_genotypes(ploidy: int, alleles: int, suffix=None, gts=None):
    """makePLGenotypes (vcfupdate.py:31-45): VCF-spec GT ordering."""
    if not isinstance(gts, list):
        gts = []
    if not isinstance(suffix, list):
        suffix = []
    for allele in range(alleles + 1):
        if ploidy == 1:
            new_suffix = suffix[:]
            new_suffix.insert(0, allele)
            gts.append(new_suffix)
        elif ploidy > 1:
            new_suffix = suffix[:]
            new_suffix.insert(0, allele)
            make_pl_genotypes(ploidy - 1, allele, new_suffix, gts)
    return gts


def read_grmpy(path_or_list) -> dict:
    """read_grmpy (vcfupdate.py:48-89)."""
    if isinstance(path_or_list, str):
        opener = gzip.open if path_or_list.endswith(".gz") else open
        with opener(path_or_list, "rt") as f:
            data = json.load(f)
    else:
        data = path_or_list
    values = [data] if isinstance(data, dict) else data
    by_id = defaultdict(list)
    by_sequencename = defaultdict(list)
    for d in values:
        gi = d.get("graphinfo", {})
        ident = gi.get("ID")
        if ident:
            by_id[ident].append(d)
        for x in gi.get("sequencenames") or []:
            by_sequencename[x].append(d)
    return {"by_id": dict(by_id), "by_sequencename": dict(by_sequencename)}


_EXTRA_HEADER_FORMATS = [
    ("GT", '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">'),
    ("FT", '##FORMAT=<ID=FT,Number=1,Type=String,'
     'Description="Filter for genotype">'),
    ("DP", '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Total '
     'filtered read depth used for genotyping.">'),
    ("AD", '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele '
     'depth for each allele, including the reference.">'),
    ("ADF", '##FORMAT=<ID=ADF,Number=R,Type=Integer,Description="Allele '
     'depth on forward strand for each allele, including the reference.">'),
    ("ADR", '##FORMAT=<ID=ADR,Number=R,Type=Integer,Description="Allele '
     'depth on reverse strand for each allele, including the reference.">'),
    ("PL", '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled '
     'likelihoods for genotypes as defined in the VCF specification">'),
]

_EXTRA_HEADER_FILTERS = [
    '##FILTER=<ID=BP_DEPTH,Description="One or more breakpoints have '
    'abnormal depth">',
    '##FILTER=<ID=NO_VALID_GT,Description="No valid genotypes from '
    'breakpoints">',
    '##FILTER=<ID=CONFLICT,Description="Breakpoints gave different '
    'genotypes">',
    '##FILTER=<ID=BP_NO_GT,Description="One genotype was missing">',
    '##FILTER=<ID=NO_READS,Description="No reads could be retrieved '
    'for a breakpoint.">',
    '##FILTER=<ID=DEPTH,Description="Poisson depth filter: observed depth '
    'deviates too far from Poisson expectation">',
    '##FILTER=<ID=UNMATCHED,Description="VCF record could not be matched '
    'to a paragraph record.">',
    '##FILTER=<ID=MULTIMATCHED,Description="VCF record could not be '
    'matched to a paragraph record uniquely.">',
]

_GRMPY_INFO_LINE = (
    '##INFO=<ID=GRMPY_ID,Number=1,Type=String,Description="Graph ID '
    'for linking to genotypes.json.gz; matches record.graphinfo.ID '
    'in there.">')

_OLD_GT_LINE = (
    '##FORMAT=<ID=OLD_GT,Number=1,Type=String,Description="Previous GT '
    'which was replaced by paragraph">')


def update_vcf_from_grmpy(in_vcf: str, grmpy_output: dict, out_vcf: str,
                          sample_names: Optional[List[str]] = None) -> dict:
    """update_vcf_from_grmpy (vcfupdate.py:92-245).

    Returns match statistics.
    """
    reader = VcfReader(in_vcf)
    vcf_samples = list(reader.samples)

    header_lines = list(reader.header_lines)
    if vcf_samples:
        header_lines.append(_OLD_GT_LINE)

    if sample_names is None:
        sample_names = vcf_samples
        if not sample_names:
            raise ValueError("No sample names available")
    # deterministic ordering: VCF samples first, then added manifest samples
    # in manifest order (reference used python-set iteration order here)
    added_samples = [s for s in sample_names if s not in vcf_samples]
    all_samples = vcf_samples + added_samples

    existing = "\n".join(header_lines)
    for key, line in _EXTRA_HEADER_FORMATS:
        if f"##FORMAT=<ID={key}," not in existing:
            header_lines.append(line)
    if "##INFO=<ID=GRMPY_ID," not in existing:
        header_lines.append(_GRMPY_INFO_LINE)
    header_lines.extend(_EXTRA_HEADER_FILTERS)

    writer = VcfWriter(out_vcf, header_lines, all_samples)
    matched = unmatched = multimatched = 0

    for raw_record in reader:
        record = VcfRecord(
            chrom=raw_record.chrom, pos=raw_record.pos, vid=raw_record.id,
            ref=raw_record.ref, alts=list(raw_record.alts),
            qual=raw_record.qual, filters=list(raw_record.filters),
            info=dict(raw_record.info))

        var_id_counts: Dict[str, int] = defaultdict(int)
        var_id = generate_variant_id(record, var_id_counts)
        allele_ids = [a for a, _ in generate_allele_ids(record, var_id)]

        grmpy_records = []
        gid = raw_record.info.get("GRMPY_ID")
        if gid and gid in grmpy_output["by_id"]:
            grmpy_records = [grmpy_output["by_id"][gid]]
        if not grmpy_records:
            grmpy_records = [
                grmpy_output["by_sequencename"][a]
                for a in allele_ids if a in grmpy_output["by_sequencename"]
            ]
        records = []
        for record_list in grmpy_records:
            for r in record_list:
                if not any(r is x for x in records):
                    records.append(r)

        if not records:
            record.info["GRMPY_ID"] = "UNMATCHED"
            if "UNMATCHED" not in record.filters:
                record.filters = [
                    f for f in record.filters if f != "PASS"]
                record.filters.append("UNMATCHED")
            writer.write(record)
            unmatched += 1
            continue
        if len(records) > 1:
            multimatched += 1
            ids = [r["graphinfo"]["ID"] for r in records
                   if "graphinfo" in r and "ID" in r["graphinfo"]]
            record.info["GRMPY_ID"] = "MULTIPLE:" + ",".join(ids)
            record.filters = [f for f in record.filters if f != "PASS"]
            record.filters.append("MULTIMATCHED")
            writer.write(record)
            continue
        matched += 1
        grmpy_record = records[0]
        record.info["GRMPY_ID"] = grmpy_record.get(
            "graphinfo", {}).get("ID", "NOID")

        allele_map = {"REF": 0, "ALT": 1}
        for ii, a_id in enumerate(allele_ids):
            allele_map[a_id] = ii

        # per-record FORMAT state
        fmt_keys: List[str] = []

        def touch(key):
            if key not in fmt_keys:
                fmt_keys.append(key)

        sample_values: Dict[str, Dict[str, str]] = {
            s: {} for s in all_samples}
        ft_matrix = FormatStringMatrix(all_samples)
        old_gt_matrix = FormatStringMatrix(all_samples)
        numeric_widths: Dict[str, int] = {}

        def set_numeric_vector(sample, key, values):
            numeric_widths[key] = max(numeric_widths.get(key, 0),
                                      len(values))
            sample_values[sample][key] = ",".join(
                "." if v is None else str(v) for v in values)

        num_bpdepth_sample = 0
        for sample in all_samples:
            if vcf_samples:
                touch("GT")
                for k in raw_record.fmt_keys:
                    touch(k)
                touch("OLD_GT")
                if sample in vcf_samples:
                    for k in raw_record.fmt_keys:
                        sample_values[sample][k] = (
                            raw_record.sample_values[sample].get(k, "."))
                    gt_raw = raw_record.sample_values[sample].get("GT", ".")
                    old_gt = "/".join(sorted(
                        v if v != "" else "."
                        for v in gt_raw.replace("|", "/").split("/")))
                    old_gt_matrix.assign(sample, old_gt)
            touch("GT")
            touch("DP")
            touch("FT")
            touch("AD")
            touch("ADF")
            touch("ADR")
            sample_values[sample]["GT"] = "."
            if sample in grmpy_record.get("samples", {}):
                try:
                    _set_record_for_sample(
                        record, sample, grmpy_record, allele_map,
                        sample_values, ft_matrix, set_numeric_vector,
                        touch)
                except KeyError:
                    continue
                ft_val = ft_matrix.values.get(sample) or ""
                if "BP_DEPTH" in ft_val or "BP_NO_GT" in ft_val:
                    num_bpdepth_sample += 1
        if num_bpdepth_sample * 2 > len(grmpy_record.get("samples", {})):
            record.filters = [f for f in record.filters if f != "PASS"]
            record.filters.append("BP_DEPTH")

        # render FORMAT columns
        record.fmt_keys = _order_format_keys(fmt_keys)
        for sample in all_samples:
            vals = sample_values[sample]
            vals["FT"] = ft_matrix.render(sample)
            if "OLD_GT" in record.fmt_keys:
                vals["OLD_GT"] = old_gt_matrix.render(sample)
            for key, width in numeric_widths.items():
                if key not in vals:
                    vals[key] = ",".join(["."] * width)
            record.sample_values[sample] = vals
        writer.write(record)

    writer.close()
    return {"matched": matched, "unmatched": unmatched,
            "multimatched": multimatched}


def _order_format_keys(keys: List[str]) -> List[str]:
    """htslib requires GT first; remaining keys keep first-touch order."""
    out = [k for k in keys if k == "GT"][:1]
    out += [k for k in keys if k != "GT"]
    return out


def _set_record_for_sample(record, sample, grmpy_record, allele_map,
                           sample_values, ft_matrix, set_numeric_vector,
                           touch):
    """set_record_for_sample (vcfupdate.py:248-310)."""
    gt = grmpy_record["samples"][sample]["gt"]
    filters = list(gt.get("filters", []))
    gt_to_set = sorted(
        (allele_map[g] if g in allele_map else -1)
        for g in gt["GT"].split("/"))
    gt_to_set = [g if g >= 0 else None for g in gt_to_set]
    if None in gt_to_set:
        # NB reference FT ordering follows python set iteration (random
        # per run); we deterministically place the UNMATCHED filter first,
        # matching the committed round-trip oracle
        filters = ["UNMATCHED"] + [f for f in filters if f != "UNMATCHED"]
    else:
        sample_values[sample]["GT"] = "/".join(
            str(g) for g in gt_to_set)
    ft_matrix.assign(sample, ",".join(filters))
    sample_values[sample]["DP"] = str(gt.get("num_reads", 0))

    n_alts = len(record.alts)
    ad = grmpy_record["samples"][sample]["alleles"]
    ads = [0] * (1 + n_alts)
    adfs = [0] * (1 + n_alts)
    adrs = [0] * (1 + n_alts)
    for a in ad.keys():
        idx = allele_map[a]
        ads[idx] = ad[a]["num_fwd_reads"] + ad[a]["num_rev_reads"]
        adfs[idx] = ad[a]["num_fwd_reads"]
        adrs[idx] = ad[a]["num_rev_reads"]
    set_numeric_vector(sample, "AD", ads)
    set_numeric_vector(sample, "ADF", adfs)
    set_numeric_vector(sample, "ADR", adrs)

    ploidy = len(gt_to_set)
    gtlist = make_pl_genotypes(ploidy, n_alts)
    gtlist_map = {str(g): i for i, g in enumerate(gtlist)}
    pls = [0] * len(gtlist)
    min_pl = None
    if "GL" not in gt:
        return
    for name, ll in gt["GL"].items():
        alleles = sorted(allele_map[a] for a in name.split("/"))
        try:
            # reference vcfupdate is python: round() = banker's rounding
            phred_l = round(-10 * ll)
        except TypeError:
            phred_l = None
        except OverflowError:
            phred_l = 32768
        if phred_l is not None:
            phred_l = min(phred_l, 32768)
        if min_pl is None or (phred_l is not None and phred_l < min_pl):
            min_pl = phred_l
        if str(alleles) in gtlist_map:
            pls[gtlist_map[str(alleles)]] = phred_l
    pls = [pl - min_pl for pl in pls]
    touch("PL")
    set_numeric_vector(sample, "PL", pls)
