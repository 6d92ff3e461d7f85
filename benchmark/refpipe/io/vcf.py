"""VCF reading and writing (no pysam / htslib dependency).

Provides the subset of functionality the pipeline needs:

- ``VcfReader``: header + records with INFO dict, samples, ``pos`` (1-based)
  and ``stop`` (1-based inclusive end; END info key or pos+len(ref)-1 —
  pysam ``record.stop`` semantics used throughout the reference's
  vcfgraph.py).
- ``VcfWriter``: plain or BGZF-compressed text output.
- ``FormatStringMatrix``: emulates the htslib per-record fixed-width FORMAT
  string storage including the observable resize behaviour captured in the
  reference round-trip oracle (share/test-data/round-trip-genotyping/
  expected-vcf-record.txt): when a later sample assignment grows the
  per-sample string width, previously stored values are replaced by '.'
  characters of their original length.
"""
from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Tuple

from .bgzf import BgzfWriter


def _parse_info(info_str: str) -> Dict[str, object]:
    info: Dict[str, object] = {}
    if info_str in (".", ""):
        return info
    for item in info_str.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            info[k] = v
        else:
            info[item] = True
    return info


def _format_info(info: Dict[str, object]) -> str:
    if not info:
        return "."
    parts = []
    for k, v in info.items():
        if v is True:
            parts.append(k)
        else:
            parts.append(f"{k}={v}")
    return ";".join(parts)


class VcfRecord:
    def __init__(self, chrom, pos, vid, ref, alts, qual, filters, info,
                 fmt_keys=None, sample_values=None):
        self.chrom = chrom
        self.pos = pos  # 1-based
        self.id = vid  # None if '.'
        self.ref = ref
        self.alts: Tuple[str, ...] = tuple(alts)
        self.qual = qual  # None if '.'
        self.filters: List[str] = filters  # [] if '.'
        self.info: Dict[str, object] = info
        self.fmt_keys: List[str] = fmt_keys or []
        # sample name -> {key: raw string value}
        self.sample_values: Dict[str, Dict[str, str]] = sample_values or {}

    @property
    def alleles(self) -> Tuple[str, ...]:
        return (self.ref,) + self.alts

    @property
    def stop(self) -> int:
        """1-based inclusive end (pysam record.stop semantics)."""
        if "END" in self.info:
            try:
                return int(self.info["END"])
            except (TypeError, ValueError):
                pass
        return self.pos + len(self.ref) - 1

    def to_line(self, sample_names: List[str]) -> str:
        fields = [
            self.chrom,
            str(self.pos),
            self.id if self.id else ".",
            self.ref,
            ",".join(self.alts) if self.alts else ".",
            "." if self.qual is None else str(self.qual),
            ";".join(self.filters) if self.filters else ".",
            _format_info(self.info),
        ]
        if self.fmt_keys:
            fields.append(":".join(self.fmt_keys))
            for s in sample_names:
                vals = self.sample_values.get(s, {})
                fields.append(
                    ":".join(vals.get(k, ".") for k in self.fmt_keys))
        return "\t".join(fields)


def _is_bcf(path: str) -> bool:
    """True if the file's (possibly BGZF-compressed) payload is BCF."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:3] == b"BCF":
        return True
    if head[:2] != b"\x1f\x8b":
        return False
    with gzip.open(path, "rb") as f:
        return f.read(3) == b"BCF"


class VcfReader:
    def __init__(self, path: str):
        self.path = path
        self.header_lines: List[str] = []
        self.samples: List[str] = []
        self._bcf = None
        if _is_bcf(path):
            from .bcf import BcfReader

            self._bcf = BcfReader(path)
            self.header_lines = self._bcf.header_lines
            self.samples = self._bcf.samples
            self._fh = None
            return
        opener = gzip.open if path.endswith(".gz") else open
        self._fh = opener(path, "rt")
        for line in self._fh:
            line = line.rstrip("\n")
            if line.startswith("##"):
                self.header_lines.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    self.samples = cols[9:]
                self._chrom_line = line
                break
            else:
                raise ValueError(f"Malformed VCF header in {path}")

    def __iter__(self):
        if self._bcf is not None:
            for fields in self._bcf:
                yield VcfRecord(**fields)
            return
        for line in self._fh:
            line = line.rstrip("\n")
            if not line:
                continue
            yield self.parse_line(line)

    def parse_line(self, line: str) -> VcfRecord:
        cols = line.split("\t")
        chrom, pos, vid, ref, alt, qual, filt, info = cols[:8]
        fmt_keys = []
        sample_values: Dict[str, Dict[str, str]] = {}
        if len(cols) > 8:
            fmt_keys = cols[8].split(":")
            for name, raw in zip(self.samples, cols[9:]):
                vals = raw.split(":")
                sample_values[name] = {
                    k: (vals[i] if i < len(vals) else ".")
                    for i, k in enumerate(fmt_keys)
                }
        return VcfRecord(
            chrom=chrom,
            pos=int(pos),
            vid=None if vid == "." else vid,
            ref=ref,
            alts=[] if alt == "." else alt.split(","),
            qual=None if qual == "." else qual,
            filters=[] if filt in (".", "") else filt.split(";"),
            info=_parse_info(info),
            fmt_keys=fmt_keys,
            sample_values=sample_values,
        )

    def close(self):
        if self._bcf is not None:
            self._bcf.close()
        else:
            self._fh.close()


class VcfWriter:
    def __init__(self, path: str, header_lines: List[str], samples: List[str]):
        self.path = path
        self.samples = samples
        if path.endswith(".bcf"):
            from .bcf import BcfWriter

            self._bcf = BcfWriter(path, header_lines, samples)
            self._sink = None
            return
        self._bcf = None
        if path.endswith(".gz"):
            self._sink = BgzfWriter(path)
            self._write = lambda s: self._sink.write(s.encode())
        else:
            self._fh = open(path, "w")
            self._sink = None
            self._write = self._fh.write
        for line in header_lines:
            self._write(line + "\n")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if samples:
            cols.append("FORMAT")
            cols.extend(samples)
        self._write("\t".join(cols) + "\n")

    def write(self, record: VcfRecord):
        if self._bcf is not None:
            self._bcf.write(record)
            return
        self._write(record.to_line(self.samples) + "\n")

    def close(self):
        if self._bcf is not None:
            self._bcf.close()
        elif self._sink is not None:
            self._sink.close()
        else:
            self._fh.close()


class FormatStringMatrix:
    """Per-record htslib FORMAT string matrix emulation.

    Reproduces the storage behaviour observed in the reference oracle:
    values are kept in a fixed-width char matrix; growing the width (by
    assigning a longer value to some sample) turns every *other* sample's
    stored bytes into missing characters ('.' repeated over the stored
    length). See expected-vcf-record.txt: FT "PASS" → "...." when a later
    sample stores the longer "UNMATCHED,NO_VALID_GT".
    """

    def __init__(self, samples: List[str]):
        self.samples = samples
        self.values: Dict[str, Optional[str]] = {s: None for s in samples}
        self.width = 1

    def assign(self, sample: str, value: str) -> None:
        new_width = max(self.width, len(value))
        if new_width > self.width:
            for s in self.samples:
                if s != sample and self.values[s] is not None:
                    self.values[s] = "." * len(self.values[s])
            self.width = new_width
        self.values[sample] = value

    def render(self, sample: str) -> str:
        v = self.values[sample]
        return v if v else "."
