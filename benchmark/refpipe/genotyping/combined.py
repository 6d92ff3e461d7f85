"""Whole-variant consensus genotyping across breakpoints.

Equivalent of ``genotyping::combinedGenotype``
(the reference's src/c++/lib/genotyping/CombinedGenotype.cpp).
"""
from __future__ import annotations

from typing import Optional

from ..utils.numerics import c_round
from .breakpoint_genotyper import (BreakpointGenotyper,
                                   BreakpointGenotyperParameter)
from .genotype import Genotype, GenotypeSet

_DBL_MIN = 2.2250738585072014e-308


def combined_genotype(
        genotypes: GenotypeSet,
        b_param: Optional[BreakpointGenotyperParameter] = None,
        p_genotyper: Optional[BreakpointGenotyper] = None) -> Genotype:
    """combinedGenotype (CombinedGenotype.cpp:46-83)."""
    result = Genotype()
    num_pass = count_unique_genotypes(genotypes, True)
    if num_pass == 0:
        num_fail = count_unique_genotypes(genotypes, False)
        if num_fail == 0:
            result.filters.add("NO_VALID_GT")
        elif num_fail == 1:
            result = report_consensus_genotypes(genotypes, False)
        else:
            result = genotype_by_total_counts(
                genotypes, False, p_genotyper, b_param)
    elif num_pass == 1:
        result = report_consensus_genotypes(genotypes, True)
    else:
        result = genotype_by_total_counts(
            genotypes, True, p_genotyper, b_param)

    if not result.filters:
        result.filters.add("PASS")
    return result


def count_unique_genotypes(genotypes: GenotypeSet, pass_only: bool) -> int:
    """countUniqGenotypes (CombinedGenotype.cpp:85-109)."""
    voted = set()
    for bp in genotypes:
        if not bp.gt:
            continue
        if pass_only and bp.filters:
            continue
        voted.add(tuple(sorted(bp.gt)))
    return len(voted)


def report_consensus_genotypes(genotypes: GenotypeSet,
                               pass_only: bool) -> Genotype:
    """reportConsensusGenotypes (CombinedGenotype.cpp:111-207)."""
    result = Genotype()
    gls = {}
    result.num_reads = 0
    result.allele_fractions = []
    gqs = []
    for bp in genotypes:
        if not bp.gt:
            result.filters.add("BP_NO_GT")
            continue
        if pass_only and bp.filters:
            result.filters.update(bp.filters)
            continue
        if not result.gt:
            result.gt = sorted(bp.gt)
        result.num_reads += bp.num_reads
        if result.gt:
            gqs.append(bp.gq)
        if len(bp.allele_fractions) > len(result.allele_fractions):
            result.allele_fractions += [0.0] * (
                len(bp.allele_fractions) - len(result.allele_fractions))
        for i, af in enumerate(bp.allele_fractions):
            result.allele_fractions[i] += bp.num_reads * af
        for name, gl in zip(bp.gl_name, bp.gl):
            sorted_name = tuple(sorted(name))
            key = "|".join(str(g) for g in sorted_name)
            if key not in gls:
                gls[key] = (sorted_name, gl)
            else:
                gls[key] = (gls[key][0], max(gls[key][1], gl))
    # C++ divides by zero here when no reads were counted (NaN/Inf floats)
    def _div(af, n):
        if n:
            return af / n
        import math

        return float("nan") if af == 0 else math.copysign(math.inf, af)

    result.allele_fractions = [
        _div(af, result.num_reads) for af in result.allele_fractions]
    for key in gls:
        name, gl = gls[key]
        result.gl.append(gl)
        result.gl_name.append(name)
    result.gq = min(gqs) if gqs else 0
    return result


def genotype_by_total_counts(
        genotypes: GenotypeSet, use_pass_only: bool,
        p_genotyper: BreakpointGenotyper,
        b_param: BreakpointGenotyperParameter) -> Genotype:
    """genotypeByTotalCounts (CombinedGenotype.cpp:209-265)."""
    assert p_genotyper is not None
    assert b_param.read_depth > 0 and b_param.read_length > 0
    filters = {"CONFLICT"}
    sum_counts = []
    num_bp = 0
    for bp in genotypes:
        if use_pass_only and bp.filters:
            filters.update(bp.filters)
            continue
        if bp.num_reads == 0:
            filters.add("BP_NO_GT")
            continue
        if not sum_counts:
            sum_counts = [0] * len(bp.allele_fractions)
        else:
            assert len(sum_counts) == len(bp.allele_fractions)
        for i, af in enumerate(bp.allele_fractions):
            sum_counts[i] += c_round(af * bp.num_reads)
        num_bp += 1
    sum_counts = [c_round(s / num_bp) for s in sum_counts]
    result = p_genotyper.genotype(b_param, sum_counts)
    result.filters = filters
    return result
