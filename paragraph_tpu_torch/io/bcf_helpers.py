"""VCF/BCF record accessors and multiallelic splitting.

Equivalent of the reference's bcfhelpers namespace
(the reference's src/c++/lib/common/BCFHelpers.cpp, 1546 LoC): typed
INFO/FORMAT accessors with the same lookup fallbacks (GQX→GQ, DP→DPI),
GT parsing with phasing, reference padding helpers, and the
bcftools-derived multiallelic record splitter with Number=A/R/G
reshaping. Operates on the htslib-free record model of io/vcf.py
(VcfRecord with raw string sample values) plus header metadata parsed
from the ``##INFO``/``##FORMAT`` lines.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

from .vcf import VcfRecord

_META_RE = re.compile(r'##(INFO|FORMAT)=<ID=([^,>]+),Number=([^,>]+),'
                      r'Type=([^,>]+)')


class HeaderMeta:
    """Number/Type metadata for INFO and FORMAT fields, parsed from
    header lines (the htslib header-dictionary subset the accessors
    need)."""

    def __init__(self, header_lines: List[str]):
        self.info: Dict[str, Tuple[str, str]] = {}
        self.fmt: Dict[str, Tuple[str, str]] = {}
        for line in header_lines:
            m = _META_RE.match(line)
            if m:
                kind, fid, number, ftype = m.groups()
                dest = self.info if kind == "INFO" else self.fmt
                dest[fid] = (number, ftype)


class ImportError_(ValueError):
    """bcfhelpers::importexception equivalent."""


def alleles_to_gt(a: int, b: int) -> int:
    """htslib bcf_alleles2gt: index of the (a, b) genotype in the
    standard VCF Number=G ordering."""
    if a > b:
        a, b = b, a
    return b * (b + 1) // 2 + a


def get_location(rec: VcfRecord) -> Tuple[int, int]:
    """getLocation (BCFHelpers.cpp:353-377): 0-based [refstart, refend];
    INFO/END overrides the REF-length end and skips REF validation."""
    refstart = rec.pos - 1
    endfield = get_info_int(rec, "END", -1)
    if endfield > 0:
        return refstart, endfield - 1
    if "." in rec.ref or "-" in rec.ref:
        raise ImportError_(
            "[W] Unsupported REF allele with undefined length: " + rec.ref)
    return refstart, refstart + len(rec.ref) - 1


# -- INFO accessors (BCFHelpers.cpp:384-475) --------------------------------

def get_info_string(rec: VcfRecord, field: str, default: str = "") -> str:
    v = rec.info.get(field)
    if v is None or v is True:
        return default
    return str(v)


def get_info_int(rec: VcfRecord, field: str, default: int = -1) -> int:
    v = rec.info.get(field)
    if v is None or v is True:
        return default
    try:
        return int(str(v).split(",")[0])
    except ValueError:
        return default


def get_info_ints(rec: VcfRecord, field: str) -> List[int]:
    v = rec.info.get(field)
    if v is None or v is True:
        return []
    out = []
    for item in str(v).split(","):
        try:
            out.append(int(item))
        except ValueError:
            return []
    return out


def get_info_float(rec: VcfRecord, field: str) -> float:
    v = rec.info.get(field)
    if v is None or v is True:
        return math.nan
    try:
        return float(str(v).split(",")[0])
    except ValueError:
        return math.nan


def get_info_floats(rec: VcfRecord, field: str) -> List[float]:
    v = rec.info.get(field)
    if v is None or v is True:
        return []
    out = []
    for item in str(v).split(","):
        try:
            out.append(float(item))
        except ValueError:
            return []
    return out


def get_info_flag(rec: VcfRecord, field: str) -> bool:
    return rec.info.get(field) is True


# -- FORMAT accessors (BCFHelpers.cpp:477-712) ------------------------------

def _raw_format(rec: VcfRecord, field: str, sample: str) -> Optional[str]:
    if field not in rec.fmt_keys:
        return None
    v = rec.sample_values.get(sample, {}).get(field)
    if v in (None, "", "."):
        return None
    return v


def get_gt(rec: VcfRecord, sample: str) -> Tuple[List[int], bool]:
    """getGT (BCFHelpers.cpp:477-530): allele indexes (-1 = missing)
    plus phasing flag; absent GT yields ([], False)."""
    raw = _raw_format(rec, "GT", sample)
    if raw is None:
        return [], False
    phased = "|" in raw
    gt = []
    for a in re.split(r"[|/]", raw):
        gt.append(-1 if a in (".", "") else int(a))
    return gt, phased


def get_gq(rec: VcfRecord, sample: str) -> float:
    """getGQ (BCFHelpers.cpp:536-561): GQX, then GQ, then -1."""
    for field in ("GQX", "GQ"):
        raw = _raw_format(rec, field, sample)
        if raw is not None:
            return float(raw.split(",")[0])
    return -1.0


def get_ad(rec: VcfRecord, sample: str, max_ad: int) -> List[int]:
    """getAD (BCFHelpers.cpp:563-582): first max_ad AD values (zeros
    when absent, mirroring the caller-zeroed output array)."""
    out = [0] * max_ad
    raw = _raw_format(rec, "AD", sample)
    if raw is not None:
        for q, item in enumerate(raw.split(",")[:max_ad]):
            if item != ".":
                out[q] = int(item)
    return out


def get_dp(rec: VcfRecord, sample: str) -> int:
    """getDP (BCFHelpers.cpp:584-609): DP, then DPI, then 0."""
    for field in ("DP", "DPI"):
        raw = _raw_format(rec, field, sample)
        if raw is not None:
            return int(raw.split(",")[0])
    return 0


def get_format_int(rec: VcfRecord, field: str, sample: str,
                   default: int = -1) -> int:
    raw = _raw_format(rec, field, sample)
    if raw is None:
        return default
    vals = raw.split(",")
    if len(vals) > 1:
        raise ImportError_(f"[W] too many {field} fields at "
                           f"{rec.chrom}:{rec.pos}")
    return int(vals[0])


def get_format_ints(rec: VcfRecord, field: str, sample: str) -> List[int]:
    raw = _raw_format(rec, field, sample)
    if raw is None:
        return []
    try:
        return [int(x) for x in raw.split(",") if x != "."]
    except ValueError:
        return []


def get_format_float(rec: VcfRecord, field: str, sample: str) -> float:
    raw = _raw_format(rec, field, sample)
    if raw is None:
        return math.nan
    vals = raw.split(",")
    if len(vals) > 1:
        raise ImportError_(f"[W] too many {field} fields at "
                           f"{rec.chrom}:{rec.pos}")
    return float(vals[0])


def get_format_floats(rec: VcfRecord, field: str, sample: str
                      ) -> List[float]:
    raw = _raw_format(rec, field, sample)
    if raw is None:
        return []
    try:
        return [float(x) for x in raw.split(",") if x != "."]
    except ValueError:
        return []


def get_format_string(rec: VcfRecord, field: str, sample: str,
                      default: str = ".") -> str:
    raw = _raw_format(rec, field, sample)
    return default if raw is None else raw


def set_format(rec: VcfRecord, field: str, values: Dict[str, object]
               ) -> None:
    """setFormatInts/Floats/Strings (BCFHelpers.cpp:772-890): assign a
    per-sample value (list values join with commas)."""
    if field not in rec.fmt_keys:
        rec.fmt_keys.append(field)
    for sample, v in values.items():
        if isinstance(v, (list, tuple)):
            v = ",".join(str(x) for x in v)
        rec.sample_values.setdefault(sample, {})[field] = str(v)


# -- reference padding (BCFHelpers.cpp:910-978) -----------------------------

def add_ref_pad(rec: VcfRecord, fasta, npad: int) -> int:
    """addRefPad: prepend npad reference bases to POS and every
    non-symbolic allele."""
    if npad <= 0:
        raise ValueError("npad<=0")
    start, _end = get_location(rec)
    pad = fasta.query(f"{rec.chrom}:{start - npad + 1}-{start}")
    rec.pos -= npad
    rec.ref = pad + rec.ref
    rec.alts = tuple(a if a.startswith("<") else pad + a for a in rec.alts)
    return npad


def is_ref_padded(rec: VcfRecord) -> int:
    """isRefPadded (BCFHelpers.cpp:943-978): number of shared leading
    REF bases across all non-symbolic ALTs (0 with no ALTs)."""
    if not rec.alts:
        return 0
    max_match = len(rec.ref)
    for alt in rec.alts:
        if alt == "." or alt.startswith("<"):
            return 0
        rpos = 0
        while (rpos < len(rec.ref) and rpos < len(alt)
               and alt[rpos] == rec.ref[rpos]):
            rpos += 1
        max_match = min(rpos, max_match)
    return max_match


# -- multiallelic splitting (BCFHelpers.cpp:980-1496, after bcftools) -------

def _split_values(values: List[str], number: str, n_allele: int,
                  ialt: int) -> Optional[List[str]]:
    """Select the ialt-specific subset of a Number=A/R/G value list;
    None = wrong field count (skip the field, as bcftools does)."""
    if number == "A":
        if len(values) != n_allele - 1:
            return None
        return [values[ialt]]
    if number == "R":
        if len(values) != n_allele:
            return None
        return [values[0], values[ialt + 1]]
    if number == "G":
        n_gts = n_allele * (n_allele + 1) // 2
        if len(values) == n_allele:     # all-haploid
            return [values[0], values[ialt + 1]]
        if len(values) != n_gts:
            return None
        return [values[0], values[alleles_to_gt(0, ialt + 1)],
                values[alleles_to_gt(ialt + 1, ialt + 1)]]
    return list(values)


def _split_gt(raw: str, ialt: int) -> str:
    """split_format_genotype (BCFHelpers.cpp:1136-1172): the selected
    ALT becomes allele 1, every other ALT becomes REF; missing and REF
    calls and phasing stay as they are."""
    sep = "|" if "|" in raw else "/"
    out = []
    for a in re.split(r"[|/]", raw):
        if a in (".", "") or a == "0":
            out.append(a)
        elif int(a) == ialt + 1:
            out.append("1")
        else:
            out.append("0")
    return sep.join(out)


def split_multi_allelics(meta: HeaderMeta, rec: VcfRecord,
                         samples: List[str]) -> List[VcfRecord]:
    """splitMultiAllelics (BCFHelpers.cpp:1418-1496): one biallelic
    record per ALT, with INFO and FORMAT fields reshaped by their
    declared Number and GT remapped per allele."""
    out: List[VcfRecord] = []
    n_allele = len(rec.alts) + 1
    for ialt in range(n_allele - 1):
        info: Dict[str, object] = {}
        for k, v in rec.info.items():
            if v is True:
                info[k] = True
                continue
            number = meta.info.get(k, (".", "String"))[0]
            vals = _split_values(str(v).split(","), number, n_allele, ialt)
            if vals is not None:
                info[k] = ",".join(vals)
        sample_values: Dict[str, Dict[str, str]] = {}
        for sample in samples:
            row = rec.sample_values.get(sample, {})
            new_row: Dict[str, str] = {}
            for k in rec.fmt_keys:
                raw = row.get(k)
                if raw is None:
                    continue
                if k == "GT":
                    new_row[k] = _split_gt(raw, ialt)
                    continue
                if raw == ".":
                    new_row[k] = raw
                    continue
                number = meta.fmt.get(k, (".", "String"))[0]
                vals = _split_values(str(raw).split(","), number,
                                     n_allele, ialt)
                if vals is not None:
                    new_row[k] = ",".join(vals)
            sample_values[sample] = new_row
        out.append(VcfRecord(
            rec.chrom, rec.pos, rec.id, rec.ref, (rec.alts[ialt],),
            rec.qual, list(rec.filters), info, list(rec.fmt_keys),
            sample_values))
    return out


def extract_ref_from_mnp(rec: VcfRecord, i: int) -> Optional[VcfRecord]:
    """extractRefFromMNP (BCFHelpers.cpp:1499-1545): hom-ref record for
    base i of a MNP's REF allele; requires DP and DPF, converts GQ to
    integer GQX. Returns None when DP/DPF are unavailable."""
    assert rec.alts
    sample_values: Dict[str, Dict[str, str]] = {}
    fmt_keys = ["GT"]
    for sample, row in rec.sample_values.items():
        new_row = {"GT": "0/0"}
        gq = row.get("GQ")
        if gq not in (None, "."):
            new_row["GQX"] = str(int(float(gq.split(",")[0])))
            if "GQX" not in fmt_keys:
                fmt_keys.append("GQX")
        for need in ("DP", "DPF"):
            v = row.get(need)
            if v in (None, "."):
                return None
            new_row[need] = v.split(",")[0]
            if need not in fmt_keys:
                fmt_keys.append(need)
        sample_values[sample] = new_row
    return VcfRecord(rec.chrom, rec.pos + i, None, rec.ref[i], (".",),
                     None, list(rec.filters), {}, fmt_keys, sample_values)
