"""Genotype container with GL/GQ/filters and allele relabelling.

Equivalent of ``genotyping::Genotype`` (the reference's src/c++/lib/
genotyping/Genotype.cpp) and ``GenotypeSet`` (GenotypeSet.cpp).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple


class Genotype:
    def __init__(self):
        self.gt: List[int] = []
        self.gl_name: List[Tuple[int, ...]] = []
        self.gl: List[float] = []
        self.gq: int = -1
        self.num_reads: int = 0
        self.allele_fractions: List[float] = []
        self.coverage_test_pvalue: float = -1.0
        self.filters: Set[str] = set()

    def copy(self) -> "Genotype":
        g = Genotype()
        g.gt = list(self.gt)
        g.gl_name = list(self.gl_name)
        g.gl = list(self.gl)
        g.gq = self.gq
        g.num_reads = self.num_reads
        g.allele_fractions = list(self.allele_fractions)
        g.coverage_test_pvalue = self.coverage_test_pvalue
        g.filters = set(self.filters)
        return g

    def to_string(self, allele_names: Optional[List[str]] = None) -> str:
        if not self.gt:
            return "."
        if allele_names is None:
            return "/".join(str(g) for g in self.gt)
        return "/".join(allele_names[g] for g in self.gt)

    def filter_string(self) -> str:
        return ";".join(sorted(self.filters))

    def relabel(self, new_labels: List[int]) -> None:
        """Genotype::relabel (Genotype.cpp:94-126)."""
        self.gt = sorted(new_labels[g] for g in self.gt)
        self.gl_name = [tuple(sorted(new_labels[g] for g in l))
                        for l in self.gl_name]
        new_af = [0.0] * len(new_labels)
        for g, af in enumerate(self.allele_fractions):
            new_af[new_labels[g]] = af
        self.allele_fractions = new_af

    def to_json(self, allele_names: List[str]) -> dict:
        """Genotype::toJson (Genotype.cpp:129-182)."""
        out: dict = {"GT": self.to_string(allele_names)}
        if self.gl:
            gl_obj = {}
            for name, value in zip(self.gl_name, self.gl):
                gl_str = "/".join(allele_names[g] for g in name)
                gl_obj[gl_str] = value
            out["GL"] = gl_obj
        if self.gq != -1:
            out["GQ"] = self.gq
        if self.allele_fractions:
            out["allele_fractions"] = {
                allele_names[a]: af
                for a, af in enumerate(self.allele_fractions)
            }
        if self.filters:
            out["filters"] = sorted(self.filters)
        if self.gt:
            out["num_reads"] = self.num_reads
            if self.coverage_test_pvalue != -1:
                out["coverage_test_pvalue"] = self.coverage_test_pvalue
        return out


class GenotypeSet:
    """Per-breakpoint collection with merged allele-name space
    (GenotypeSet.cpp:40-64)."""

    def __init__(self):
        self.merged_allele_names: List[str] = []
        self.genotypes: List[Genotype] = []

    def add(self, allele_names: List[str], gt: Genotype) -> int:
        remapped = gt.copy()
        mapping = []
        for a in allele_names:
            if a in self.merged_allele_names:
                mapping.append(self.merged_allele_names.index(a))
            else:
                mapping.append(len(self.merged_allele_names))
                self.merged_allele_names.append(a)
        remapped.relabel(mapping)
        self.genotypes.append(remapped)
        return len(self.genotypes) - 1

    def __iter__(self):
        return iter(self.genotypes)

    def __len__(self):
        return len(self.genotypes)
