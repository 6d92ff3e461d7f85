"""Population-level statistics: HWE, call rate, allele frequencies.

Equivalent of ``genotyping::PopulationStatistics``
(the reference's src/c++/lib/genotyping/PopulationStatistics.cpp),
including the Wigginton 2005 exact HWE test used as a fallback for small
bi-allelic cohorts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from ..utils.numerics import c_round
from .breakpoint_genotyper import _gammaincc
from .genotype import GenotypeSet


def chi_squared_cdf_1df(x: float) -> float:
    """cdf of chi-squared with 1 dof = P(1/2, x/2)."""
    return 1.0 - _gammaincc(0.5, x / 2.0)


class PopulationStatistics:
    def __init__(self, genotypes: GenotypeSet):
        self.num_valid_samples = 0
        self.num_total_samples = len(genotypes)
        self.genotype_counts: Dict[Tuple[int, ...], int] = {}
        self.allele_counts: List[int] = []
        for genotype in genotypes:
            if not genotype.gt:
                continue
            self.num_valid_samples += 1
            key = tuple(genotype.gt)
            self.genotype_counts[key] = self.genotype_counts.get(key, 0) + 1
            for gt in genotype.gt:
                if len(self.allele_counts) <= gt:
                    self.allele_counts += [0] * (
                        gt + 1 - len(self.allele_counts))
                self.allele_counts[gt] += 1

    def to_json(self) -> dict:
        hwe_p_chisq = self.chisq_pvalue()
        hwe_p_fisher = -1.0
        if self.need_fisher_exact():
            hwe_p_fisher = self.fisher_exact_pvalue()
        return {
            "hwe": hwe_p_chisq,
            "hwe_fisher": "" if hwe_p_fisher == -1 else hwe_p_fisher,
            "call_rate": self.call_rate(),
            "allele_frequencies": self.allele_frequencies(),
        }

    def call_rate(self) -> float:
        return self.num_valid_samples / self.num_total_samples

    def chisq_pvalue(self) -> float:
        """PopulationStatistics::getChisqPvalue
        (PopulationStatistics.cpp:102-136)."""
        chisq_val = 0.0
        for gv, count in self.genotype_counts.items():
            if len(gv) != 2:
                continue
            h1, h2 = gv
            if self.allele_counts[h1] == 0 or self.allele_counts[h2] == 0:
                continue
            n = self.num_valid_samples
            if h1 == h2:
                e_count = ((self.allele_counts[h1] / n / 2)
                           * (self.allele_counts[h1] / n / 2) * n)
            else:
                e_count = (2 * (self.allele_counts[h1] / n / 2)
                           * (self.allele_counts[h2] / n / 2) * n)
            diff = e_count - count
            chisq_val += diff * diff / e_count
        return 1.0 - chi_squared_cdf_1df(chisq_val)

    def min_nonzero_allele_index(self) -> int:
        """PopulationStatistics::minNonZeroAlleleIndex
        (PopulationStatistics.cpp:303-324)."""
        ac = self.allele_counts
        p_minor = min(range(len(ac)), key=lambda i: (ac[i], i))
        if ac[p_minor] > 0:
            return p_minor
        p_max = max(range(len(ac)), key=lambda i: (ac[i], -i))
        if ac[p_max] == 0:
            return 0
        best = p_max
        for i in range(len(ac)):
            if ac[i] < ac[best]:
                best = i
        return best

    def need_fisher_exact(self) -> bool:
        """PopulationStatistics::needFisherExactHWE
        (PopulationStatistics.cpp:147-185)."""
        num_observed = sum(1 for a in self.allele_counts if a > 0)
        if num_observed <= 1 or num_observed > 2:
            return False
        if self.num_valid_samples <= 30:
            return True
        for count in self.genotype_counts.values():
            if 0 < count <= 20:
                return True
        minor = self.min_nonzero_allele_index()
        maf = self.allele_counts[minor] / 2 / self.num_valid_samples
        if maf * maf * self.num_valid_samples <= 20:
            return True
        return False

    def fisher_exact_pvalue(self) -> float:
        """PopulationStatistics::getFisherExactPvalue
        (PopulationStatistics.cpp:190-280; Wigginton 2005 AJHG)."""
        ac = self.allele_counts
        minor_idx = self.min_nonzero_allele_index()
        major_idx = max(range(len(ac)), key=lambda i: (ac[i], -i))
        minor_count = ac[minor_idx]
        major_count = ac[major_idx]
        het_gv = tuple(sorted((major_idx, minor_idx)))
        observed_num_het = 0
        for gv, count in self.genotype_counts.items():
            if len(gv) != 2:
                continue
            if gv == het_gv:
                observed_num_het = count
                break
        n = self.num_valid_samples
        num_expect_het = c_round(
            2 * (minor_count / n / 2) * (major_count / n / 2) * n)

        scaled_pvals: List[float] = []
        observe_scaled = -1.0

        prev_ref_hom = (minor_count - num_expect_het) // 2
        prev_alt_hom = n - prev_ref_hom - num_expect_het
        prev_scaled = 1.0
        for num_het in range(num_expect_het, minor_count + 1, 2):
            if num_het == num_expect_het:
                scaled_pvals.append(1.0)
                continue
            prev_num_het = num_het - 2
            iscale = (prev_scaled * (4 * prev_ref_hom * prev_alt_hom)
                      / ((prev_num_het + 2) * (prev_num_het + 1)))
            scaled_pvals.append(iscale)
            prev_scaled = iscale
            prev_ref_hom -= 1
            prev_alt_hom -= 1
            if observe_scaled == -1 and num_het == observed_num_het:
                observe_scaled = iscale

        prev_ref_hom = (minor_count - num_expect_het) // 2
        prev_alt_hom = n - prev_ref_hom - num_expect_het
        prev_scaled = 1.0
        for num_het in range(num_expect_het, -1, -2):
            if num_het == num_expect_het:
                continue
            prev_num_het = num_het + 2
            iscale = (prev_scaled / 4 * prev_num_het / (prev_ref_hom + 1)
                      * (prev_num_het - 1) / (prev_alt_hom + 1))
            scaled_pvals.append(iscale)
            prev_scaled = iscale
            prev_ref_hom += 1
            prev_alt_hom += 1
            if observe_scaled == -1 and num_het == observed_num_het:
                observe_scaled = iscale

        hwe_scale_sum = sum(s for s in scaled_pvals if s <= observe_scaled)
        total = sum(scaled_pvals)
        return hwe_scale_sum / total

    def allele_frequencies(self) -> List[float]:
        total = sum(self.allele_counts)
        return [(ac / total if total > 0 else 0.0)
                for ac in self.allele_counts]
