"""Genomic region parsing and arithmetic.

Matches the semantics of the reference's ``common::Region``
(the reference's src/c++/include/common/Region.hh): regions are encoded as
``chrom:start-end`` with 1-based inclusive coordinates.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


_REGION_RE = re.compile(r"^([^:]+)(?::([\d,]+)(?:-([\d,]+))?)?$")


def parse_region(region: str):
    """Parse ``chrom[:start[-end]]`` into (chrom, start, end).

    start/end are 1-based inclusive ints or None when absent. Commas in
    numbers are permitted (mirrors the python helpers in the reference,
    src/python/lib/grm/helpers.py).
    """
    m = _REGION_RE.match(region)
    if not m:
        raise ValueError(f"Cannot parse region: {region}")
    chrom = m.group(1)
    start = int(m.group(2).replace(",", "")) if m.group(2) else None
    end = int(m.group(3).replace(",", "")) if m.group(3) else None
    return chrom, start, end


@dataclass(frozen=True)
class Region:
    chrom: str
    start: int  # 1-based inclusive
    end: int  # 1-based inclusive

    @classmethod
    def from_string(cls, s: str) -> "Region":
        chrom, start, end = parse_region(s)
        if start is None:
            raise ValueError(f"Region needs coordinates: {s}")
        if end is None:
            end = start
        return cls(chrom, start, end)

    def __str__(self) -> str:
        return f"{self.chrom}:{self.start}-{self.end}"

    def extended(self, flank: int) -> "Region":
        """Extend by `flank` bases on each side, clamping start at 1.

        Mirrors Region::getExtendedRegion used by read extraction
        (ReadExtraction.cpp:100-101).
        """
        return Region(self.chrom, max(1, self.start - flank), self.end + flank)

    @property
    def length(self) -> int:
        return self.end - self.start + 1
