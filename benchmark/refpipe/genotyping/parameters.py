"""Genotyping model parameters.

Equivalent of ``genotyping::GenotypingParameters``
(the reference's src/c++/lib/genotyping/GenotypingParameters.cpp):
defaults, VCF-spec genotype enumeration, and JSON overrides
(doc/genotyping-parameters.md).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple


def make_possible_genotypes(ploidy: int, num_alleles: int
                            ) -> List[Tuple[int, ...]]:
    """All genotypes in VCF-spec order (GenotypingParameters.cpp:54-81)."""
    gts: List[Tuple[int, ...]] = []
    if not num_alleles:
        return gts

    def make(p, n, suffix):
        for a in range(n + 1):
            if p == 1:
                gts.append(tuple([a] + suffix))
            elif p > 1:
                make(p - 1, a, [a] + suffix)

    make(ploidy, num_alleles - 1, [])
    return gts


class GenotypingParameters:
    def __init__(self, allele_names: List[str], ploidy: int = 2):
        self.ploidy = ploidy
        self.num_alleles = len(allele_names)
        self.coverage_test_cutoff = (0.02, 0.0001)
        self.min_pass_gq = 10
        self.allele_names = list(allele_names)
        self.min_overlap_bases = 16
        self.reference_allele = "REF"
        self.reference_allele_error_rate = 0.05
        self.other_allele_error_rate = 0.05
        self.other_het_haplotype_fraction = 0.5
        self.other_genotype_fraction = 1
        self.use_poisson_depth = False
        self.allele_error_rates: List[float] = []
        self.het_haplotype_fractions: List[float] = []
        self.genotype_fractions: Dict[Tuple[int, ...], float] = {}
        self.possible_genotypes = make_possible_genotypes(
            ploidy, self.num_alleles)

    def set_from_json(self, param_json: dict) -> None:
        """GenotypingParameters::setFromJson (GenotypingParameters.cpp:83+).

        Quirks replicated: a scalar het_haplotype_fraction is only honoured
        when the JSON string starts with '[' (sic), and coverage_test_cutoff
        overwrites .first twice leaving .second at its default.
        """
        uniform_het_haplotype_fraction = False
        for key, field in param_json.items():
            if key == "min_overlap_bases":
                self.min_overlap_bases = int(field)
            elif key == "reference_allele":
                self.reference_allele = str(field)
            elif key == "reference_allele_error_rate":
                self.reference_allele_error_rate = float(field)
            elif key == "other_allele_error_rate":
                self.other_allele_error_rate = float(field)
            elif key == "het_haplotype_fraction":
                if str(field).startswith("["):
                    self.other_het_haplotype_fraction = float(field)
                    uniform_het_haplotype_fraction = True
            elif key == "other_genotype_fraction":
                self.other_genotype_fraction = float(field)
            elif key == "ploidy":
                self.ploidy = int(field)

        if "coverage_test_cutoff" in param_json:
            cc = param_json["coverage_test_cutoff"]
            if len(cc) != 2:
                raise ValueError(
                    "coverage_test_cutoff needs 2 values")
            first = float(cc[0])
            first = float(cc[1])  # reference overwrites .first twice
            self.coverage_test_cutoff = (
                first, self.coverage_test_cutoff[1])

        if ("allele_error_rates" in param_json
                or ("het_haplotype_fractions" in param_json
                    and not uniform_het_haplotype_fraction)
                or "genotype_fractions" in param_json):
            if "allele_names" not in param_json:
                raise ValueError(
                    "allele_names must be specified with per-allele "
                    "parameters")
            conversion = [
                self.allele_names.index(a) if a in self.allele_names else -1
                for a in param_json["allele_names"]
            ]
            if any(c != -1 for c in conversion):
                if "allele_error_rates" in param_json:
                    self.allele_error_rates = (
                        [self.other_allele_error_rate] * self.num_alleles)
                    if self.reference_allele in self.allele_names:
                        self.allele_error_rates[
                            self.allele_names.index(self.reference_allele)
                        ] = self.reference_allele_error_rate
                    for idx, v in enumerate(
                            param_json["allele_error_rates"]):
                        if conversion[idx] != -1:
                            self.allele_error_rates[conversion[idx]] = float(v)
                if ("het_haplotype_fractions" in param_json
                        and not uniform_het_haplotype_fraction):
                    self.het_haplotype_fractions = (
                        [self.other_het_haplotype_fraction]
                        * self.num_alleles)
                    for idx, v in enumerate(
                            param_json["het_haplotype_fractions"]):
                        if conversion[idx] != -1:
                            self.het_haplotype_fractions[
                                conversion[idx]] = float(v)
                if "genotype_fractions" in param_json:
                    for gt_str, frac in param_json[
                            "genotype_fractions"].items():
                        gv = [int(x) for x in gt_str.split("/") if x != ""]
                        new_gt = []
                        for g in gv:
                            if conversion[g] != -1:
                                new_gt.append(conversion[g])
                            else:
                                break
                        if len(new_gt) == self.ploidy:
                            self.genotype_fractions[tuple(new_gt)] = float(
                                frac)
                    for gt in self.possible_genotypes:
                        if gt not in self.genotype_fractions:
                            self.genotype_fractions[gt] = (
                                self.other_genotype_fraction)

        if "use_poisson_depth" in param_json:
            v = param_json["use_poisson_depth"]
            if v == "true":
                self.use_poisson_depth = True
            elif v == "false":
                self.use_poisson_depth = False
            else:
                raise ValueError(
                    "use_poisson_depth only allows true or false")
