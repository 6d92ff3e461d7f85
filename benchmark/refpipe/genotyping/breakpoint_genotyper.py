"""Breakpoint Poisson genotyping model.

Equivalent of ``genotyping::BreakpointGenotyper``
(the reference's src/c++/lib/genotyping/BreakpointGenotyper.cpp):

  λ = depth · (read_length − min_overlap) / read_length
  GL(gt) = log prior + Σ_alleles log Poisson(count_a; λ·rate_a)
    rate_a = ε_a for absent alleles, μ_a · copies for present alleles
  GQ = −10·log10(1 − exp(best)/Σexp(GL)), capped at 100
  depth test: two-sided normal (default) or Poisson CDF on total reads.

This scalar float64 implementation is the parity engine; a batched JAX
version over (events × samples × breakpoints) lives in
``paragraph_tpu.genotyping.batched``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

from .genotype import Genotype
from .parameters import GenotypingParameters

_DBL_MAX = 1.7976931348623157e308


def log_poisson_pdf(k: int, mean: float) -> float:
    """log(pdf(poisson(mean), k)) with boost-compatible edge cases.

    boost::math::pdf(poisson, k) computes mean^k e^-mean / k! via
    gamma_p_derivative; log of that equals the log-space form to within
    1 ulp which is sufficient for integer PL/GQ parity.
    """
    if mean <= 0:
        # boost poisson requires mean > 0; reference never hits this with
        # positive depth
        return 0.0 if k == 0 else -_DBL_MAX
    pdf = math.exp(k * math.log(mean) - mean - math.lgamma(k + 1))
    if pdf <= 0:
        return -math.inf
    return math.log(pdf)


def normal_cdf(x: float, mean: float, sd: float) -> float:
    return 0.5 * math.erfc(-(x - mean) / (sd * math.sqrt(2.0)))


def poisson_cdf(k: int, mean: float) -> float:
    """P(X <= k) = Q(k+1, mean) (regularized upper incomplete gamma)."""
    # series/continued fraction implementation of gammaincc
    return _gammaincc(k + 1.0, mean)


def _gammaincc(a: float, x: float) -> float:
    if x < a + 1.0:
        return 1.0 - _gammainc_series(a, x)
    return _gammaincc_cf(a, x)


def _gammainc_series(a: float, x: float) -> float:
    if x <= 0:
        return 0.0
    ap = a
    s = 1.0 / a
    delta = s
    for _ in range(1000):
        ap += 1.0
        delta *= x / ap
        s += delta
        if abs(delta) < abs(s) * 1e-17:
            break
    return s * math.exp(-x + a * math.log(x) - math.lgamma(a))


def _gammaincc_cf(a: float, x: float) -> float:
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 1000):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-17:
            break
    return math.exp(-x + a * math.log(x) - math.lgamma(a)) * h


@dataclass
class BreakpointGenotyperParameter:
    """BreakpointGenotyperParameter (BreakpointGenotyper.hh)."""

    read_depth: float
    read_length: int
    depth_sd: float
    use_poisson_depth: bool = False


class BreakpointGenotyper:
    def __init__(self, param: GenotypingParameters):
        self.n_alleles = param.num_alleles
        self.ploidy = param.ploidy
        self.coverage_test_cutoff = param.coverage_test_cutoff
        self.min_pass_gq = param.min_pass_gq
        self.min_overlap_bases = param.min_overlap_bases
        self.possible_genotypes = param.possible_genotypes
        if not param.allele_error_rates:
            self.allele_error_rate = [param.other_allele_error_rate]
        else:
            self.allele_error_rate = list(param.allele_error_rates)
        if not param.het_haplotype_fractions:
            self.haplotype_read_fraction = [
                param.other_het_haplotype_fraction]
        else:
            self.haplotype_read_fraction = list(param.het_haplotype_fractions)
        self.genotype_prior = {
            gt: math.log(frac)
            for gt, frac in param.genotype_fractions.items()
        }

    def genotype(self, param: BreakpointGenotyperParameter,
                 read_counts_per_allele: Sequence[int]) -> Genotype:
        """BreakpointGenotyper::genotype (BreakpointGenotyper.cpp:86-192)."""
        if len(read_counts_per_allele) != self.n_alleles:
            raise ValueError("read counts / alleles mismatch")
        result = Genotype()
        multiplier = ((param.read_length - self.min_overlap_bases)
                      / param.read_length)
        assert multiplier > 0
        lam = param.read_depth * multiplier
        total = sum(read_counts_per_allele)
        if total == 0:
            result.filters.add("NO_READS")
            return result
        result.num_reads = total

        best_gl = -_DBL_MAX
        for igt in self.possible_genotypes:
            gl = self._genotype_likelihood(lam, igt, read_counts_per_allele)
            result.gl_name.append(igt)
            result.gl.append(gl)
            if gl > best_gl:
                best_gl = gl
                result.gt = list(igt)

        sum_gl = 0.0
        for l in result.gl:
            sum_gl += math.exp(l)
        pr_gt_error = 1.0 - math.exp(best_gl) / sum_gl
        if pr_gt_error == 0:
            result.gq = 100
        else:
            gq_log10 = math.log10(pr_gt_error)
            if gq_log10 < -10:
                result.gq = 100
            else:
                # C++ stores -10*log10 into an int member (truncation)
                result.gq = int(-10 * gq_log10)
        if result.gq < self.min_pass_gq:
            result.filters.add("GQ")

        result.allele_fractions = [
            c / total for c in read_counts_per_allele]

        if param.use_poisson_depth:
            coverage_test_pvalue = poisson_cdf(total, lam)
        else:
            coverage_test_pvalue = normal_cdf(total, lam, param.depth_sd)
        if coverage_test_pvalue > 0.5:
            coverage_test_pvalue = 1 - coverage_test_pvalue
            if coverage_test_pvalue < self.coverage_test_cutoff[0]:
                result.filters.add("BP_DEPTH")
        else:
            if coverage_test_pvalue < self.coverage_test_cutoff[1]:
                result.filters.add("BP_DEPTH")
        result.coverage_test_pvalue = coverage_test_pvalue
        return result

    def _genotype_likelihood(self, lam: float, gv: Sequence[int],
                             read_counts: Sequence[int]) -> float:
        """BreakpointGenotyper::genotypeLikelihood
        (BreakpointGenotyper.cpp:200-255)."""
        log_phi = self.genotype_prior.get(tuple(gv), 0.0)
        allele_ploidy = [0] * self.n_alleles
        for al in range(self.n_alleles):
            for g in gv:
                if al == g:
                    allele_ploidy[al] += 1
        gl = log_phi
        for al in range(self.n_alleles):
            if allele_ploidy[al] == 0:
                eps = (self.allele_error_rate[0]
                       if len(self.allele_error_rate) == 1
                       else self.allele_error_rate[al])
                gl += log_poisson_pdf(read_counts[al], lam * eps)
            else:
                mu = (self.haplotype_read_fraction[0]
                      if len(self.haplotype_read_fraction) == 1
                      else self.haplotype_read_fraction[al])
                gl += log_poisson_pdf(read_counts[al],
                                      lam * mu * allele_ploidy[al])
            if math.isinf(gl):
                return -_DBL_MAX
        return gl
