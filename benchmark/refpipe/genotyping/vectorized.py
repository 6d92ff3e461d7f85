"""Vectorized breakpoint genotyping: whole (breakpoint × sample) batches.

Bit-compatible float64 twin of the scalar parity engine
(``breakpoint_genotyper.py``): one call genotypes a [B, A] count matrix,
replacing the reference's per-(breakpoint, sample) loop
(the reference's src/c++/lib/genotyping/GraphBreakpointGenotyper.cpp:47-103)
with array arithmetic. Parity is engineered, not approximate:

- allele and genotype accumulation loop sequentially over the (small)
  A/G axes so float addition order matches the scalar engine exactly;
- log-factorials come from the same ``math.lgamma`` libm calls;
- the Poisson log-pdf keeps the scalar engine's exp-then-log round trip
  and its boost edge cases (mean<=0, pdf<=0, -DBL_MAX saturation);
- the depth-test p-value uses the same ``math.erfc``/gamma continued-
  fraction scalars per row (B-length loop; the expensive [B, G, A] part
  stays vectorized).

``tests/test_vectorized_genotyper.py`` asserts bitwise-identical
Genotype output against the scalar engine over randomized batches. The
float32 TPU engine for pod-scale population runs lives in ``batched.py``.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from .breakpoint_genotyper import (BreakpointGenotyperParameter, _DBL_MAX,
                                   normal_cdf, poisson_cdf)
from .genotype import Genotype
from .parameters import GenotypingParameters


def _libm_map(fn, a: np.ndarray) -> np.ndarray:
    """Apply a scalar libm function elementwise. numpy's SIMD float64
    exp/log differ from libm in the last ulp, which would break bitwise
    parity with the scalar engine; these arrays are small (B×G×A), so
    per-element libm calls cost microseconds per thousand items."""
    return np.fromiter((fn(v) for v in a.ravel()), np.float64,
                       a.size).reshape(a.shape)


class VectorizedBreakpointGenotyper:
    def __init__(self, param: GenotypingParameters):
        self.param = param
        self.n_alleles = param.num_alleles
        self.min_pass_gq = param.min_pass_gq
        self.min_overlap_bases = param.min_overlap_bases
        self.coverage_test_cutoff = param.coverage_test_cutoff
        self.possible_genotypes = param.possible_genotypes

        A = self.n_alleles
        G = len(self.possible_genotypes)
        if not param.allele_error_rates:
            eps = [param.other_allele_error_rate] * A
        else:
            eps = list(param.allele_error_rates)
        if not param.het_haplotype_fractions:
            mu = [param.other_het_haplotype_fraction] * A
        else:
            mu = list(param.het_haplotype_fractions)

        self.copies = np.zeros((G, A), dtype=np.float64)
        for gi, gv in enumerate(self.possible_genotypes):
            for g in gv:
                self.copies[gi, g] += 1
        self.eps = np.asarray(eps, np.float64)
        self.mu = np.asarray(mu, np.float64)
        prior = {gt: math.log(frac)
                 for gt, frac in param.genotype_fractions.items()}
        self.log_prior = np.asarray(
            [prior.get(tuple(gv), 0.0) for gv in self.possible_genotypes],
            np.float64)

    def genotype_batch(self, b_params: Sequence[BreakpointGenotyperParameter],
                       counts: np.ndarray) -> List[Genotype]:
        """Genotype B items at once; counts is [B, A] int."""
        B = len(b_params)
        counts = np.asarray(counts, np.int64)
        assert counts.shape == (B, self.n_alleles)
        if B == 0:
            return []
        G, A = self.copies.shape

        depth = np.asarray([p.read_depth for p in b_params], np.float64)
        rlen = np.asarray([p.read_length for p in b_params], np.float64)
        lam = depth * ((rlen - self.min_overlap_bases) / rlen)  # [B]
        total = counts.sum(axis=1)

        # scalar operand order preserved: (lam*mu)*copies for present
        # alleles, lam*eps for absent (float * is not associative)
        mean = np.where(
            self.copies[None, :, :] > 0,
            (lam[:, None, None] * self.mu[None, None, :])
            * self.copies[None, :, :],
            lam[:, None, None] * self.eps[None, None, :])  # [B, G, A]
        # log Poisson pdf with the scalar engine's exact edge cases:
        # mean<=0 -> 0 if k==0 else -DBL_MAX; exp-then-log round trip;
        # pdf<=0 -> -inf
        kk = counts[:, None, :].astype(np.float64)  # [B, 1->G, A]
        lgam = _libm_map(math.lgamma,
                         (counts + 1).astype(np.float64))[:, None, :]
        log_mean = np.full(mean.shape, -np.inf)
        pos = mean > 0
        log_mean[pos] = _libm_map(math.log, mean[pos])
        with np.errstate(invalid="ignore"):
            x = kk * log_mean - mean - lgam
        pdf = _libm_map(lambda v: math.exp(v) if v == v else math.nan, x)
        with np.errstate(divide="ignore"):
            lp = np.where(pdf > 0, 0.0, -np.inf)
        lp[pdf > 0] = _libm_map(math.log, pdf[pdf > 0])
        lp = np.where(mean <= 0,
                      np.where(kk == 0, 0.0, -_DBL_MAX), lp)

        # sequential allele accumulation (scalar addition order)
        gl = np.broadcast_to(self.log_prior[None, :], (B, G)).copy()
        for al in range(A):
            gl += lp[:, :, al]
        gl = np.where(np.isinf(gl), -_DBL_MAX, gl)

        best_idx = np.argmax(gl, axis=1)  # first max, like the > scan
        best_gl = gl[np.arange(B), best_idx]
        # sequential genotype-order sum of exp(gl), like the scalar loop
        sum_gl = np.zeros(B, np.float64)
        egl = _libm_map(math.exp, gl)
        for gi in range(G):
            sum_gl += egl[:, gi]
        with np.errstate(invalid="ignore", divide="ignore"):
            pr_err = 1.0 - egl[np.arange(B), best_idx] / sum_gl

        results: List[Genotype] = []
        for b in range(B):
            result = Genotype()
            if total[b] == 0:
                result.filters.add("NO_READS")
                results.append(result)
                continue
            result.num_reads = int(total[b])
            result.gl_name = list(self.possible_genotypes)
            result.gl = gl[b].tolist()
            result.gt = list(self.possible_genotypes[best_idx[b]])
            if pr_err[b] == 0:
                result.gq = 100
            else:
                gq_log10 = math.log10(pr_err[b])
                result.gq = 100 if gq_log10 < -10 else int(-10 * gq_log10)
            if result.gq < self.min_pass_gq:
                result.filters.add("GQ")
            result.allele_fractions = [
                int(c) / int(total[b]) for c in counts[b]]
            p = b_params[b]
            if p.use_poisson_depth:
                pv = poisson_cdf(int(total[b]), float(lam[b]))
            else:
                pv = normal_cdf(float(total[b]), float(lam[b]), p.depth_sd)
            if pv > 0.5:
                pv = 1 - pv
                if pv < self.coverage_test_cutoff[0]:
                    result.filters.add("BP_DEPTH")
            elif pv < self.coverage_test_cutoff[1]:
                result.filters.add("BP_DEPTH")
            result.coverage_test_pvalue = pv
            results.append(result)
        return results
