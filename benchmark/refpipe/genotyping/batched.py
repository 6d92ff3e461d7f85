"""Vectorized float32 genotyping on one device.

Counterpart of ``paragraph_tpu/genotyping/batched.py``: Poisson genotype
likelihoods, best genotype, GQ, the NO_READS / GQ / BP_DEPTH filters,
allele fractions and the depth test for whole (event x sample x
breakpoint) batches at once, in float32 PyTorch on the tensors' device.
It is plain tensor code (the JAX package's version is ``jnp`` under
``jit``, no Pallas kernel). The float64 engines (breakpoint_genotyper.py,
vectorized.py) remain the bit-parity path; this one agrees with them to
float32 tolerance.

Inputs are tensors on one device; the model tables come from
``model_from_parameters`` / ``make_model_inputs`` on that device, with
``gts`` a Python list.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from .parameters import make_possible_genotypes

#: the precision the likelihoods are rounded to after each step: float32,
#: as the port computes them; the benchmark's control sets a lower one
ROUND_TO = None


def genotype_tables(ploidy: int, num_alleles: int
                    ) -> Tuple[np.ndarray, list]:
    """Return (gt_matrix[G, A] allele copy counts, gts list)."""
    gts = make_possible_genotypes(ploidy, num_alleles)
    mat = np.zeros((len(gts), num_alleles), dtype=np.int32)
    for i, gv in enumerate(gts):
        for g in gv:
            mat[i, g] += 1
    return mat, gts


def _log_poisson_pmf(k, mean):
    import torch

    mean = torch.clamp_min(mean, 1e-30)
    return k * torch.log(mean) - mean - torch.lgamma(k + 1.0)


def _likelihoods(counts, depth, read_length, gt_ploidy, error_rates,
                 het_fractions, log_priors, min_overlap: int):
    """(gl [..., G], best [...], pr_err [...]) of a batch."""
    import torch

    lam = depth * (read_length - min_overlap) / read_length  # [...]
    present = gt_ploidy > 0  # [G, A]
    rate = torch.where(present, gt_ploidy * het_fractions, error_rates)
    mean = lam[..., None, None] * rate  # [..., G, A]
    lp = _log_poisson_pmf(counts[..., None, :].to(torch.float32), mean)
    if ROUND_TO is not None:
        lp = lp.to(ROUND_TO).to(torch.float32)
    gl = log_priors + lp.sum(-1)  # [..., G]
    if ROUND_TO is not None:
        gl = gl.to(ROUND_TO).to(torch.float32)
    best = torch.argmax(gl, dim=-1)
    # GQ's error probability 1 - exp(best) / sum(exp), log-sum-exp
    # stabilised
    pr_err = -torch.expm1(gl.amax(-1) - torch.logsumexp(gl, dim=-1))
    return gl, best, pr_err


def batched_genotype_likelihoods(counts, depth, read_length, gt_ploidy,
                                 error_rates, het_fractions, log_priors,
                                 min_overlap: int = 16):
    """Genotype likelihoods for a batch.

    counts:        [..., A] int32 per-allele read counts
    depth:         [...] expected depth per item
    read_length:   [...] read length per item
    gt_ploidy:     [G, A] allele copy numbers per candidate genotype
    error_rates:   [A] per-allele error rates (epsilon)
    het_fractions: [A] per-allele haplotype fractions (mu)
    log_priors:    [G] log genotype priors

    Returns (gl[..., G], best_gt[...], gq[...]) as tensors on the inputs'
    device; mirrors BreakpointGenotyper::genotype
    (BreakpointGenotyper.cpp:86-151).
    """
    import torch

    gl, best, pr_err = _likelihoods(counts, depth, read_length, gt_ploidy,
                                    error_rates, het_fractions, log_priors,
                                    min_overlap)
    # the reference's caps; 1e-300 is 0 in float32, as in the JAX package
    gq = torch.where(
        pr_err <= 0, 100.0,
        torch.clamp_max(-10.0 * torch.log10(torch.clamp_min(pr_err, 1e-300)),
                        100.0))
    return gl, best, gq


def make_model_inputs(allele_names: Sequence[str], ploidy: int = 2,
                      error_rate: float = 0.05, het_fraction: float = 0.5,
                      device="cuda"):
    """The default model tables on `device`."""
    import torch

    device = torch.device(device)
    a = len(allele_names)
    gt_ploidy, gts = genotype_tables(ploidy, a)
    f32 = torch.float32
    return {
        "gt_ploidy": torch.as_tensor(gt_ploidy, dtype=f32, device=device),
        "error_rates": torch.full((a,), error_rate, dtype=f32,
                                  device=device),
        "het_fractions": torch.full((a,), het_fraction, dtype=f32,
                                    device=device),
        "log_priors": torch.zeros((gt_ploidy.shape[0],), dtype=f32,
                                  device=device),
        "gts": gts,
    }


def model_from_parameters(param, device="cuda") -> dict:
    """Model tables on `device` from a GenotypingParameters object, with
    the same per-allele defaults the float64 engine applies
    (vectorized.py:55-74)."""
    import torch

    device = torch.device(device)
    a = param.num_alleles
    gts = param.possible_genotypes
    mat = np.zeros((len(gts), a), np.float32)
    for i, gv in enumerate(gts):
        for g in gv:
            mat[i, g] += 1
    eps = (list(param.allele_error_rates) if param.allele_error_rates
           else [param.other_allele_error_rate] * a)
    mu = (list(param.het_haplotype_fractions)
          if param.het_haplotype_fractions
          else [param.other_het_haplotype_fraction] * a)
    prior = {tuple(gt): math.log(frac)
             for gt, frac in param.genotype_fractions.items() if frac > 0}
    logp = [prior.get(tuple(gv), 0.0) for gv in gts]
    f32 = torch.float32
    return {
        "gt_ploidy": torch.as_tensor(mat, device=device),
        "error_rates": torch.tensor(eps, dtype=f32, device=device),
        "het_fractions": torch.tensor(mu, dtype=f32, device=device),
        "log_priors": torch.tensor(logp, dtype=f32, device=device),
        "gts": gts,
    }


def _normal_sf_upper(x, mean, sd):
    """P(X <= x) for Normal(mean, sd) via erfc (BreakpointGenotyper.cpp
    uses boost's normal cdf; float32 analogue)."""
    import torch

    return 0.5 * torch.special.erfc(-(x - mean) / (sd * math.sqrt(2.0)))


def batched_genotype_full(counts, depth, read_length, depth_sd,
                          use_poisson, gt_ploidy, error_rates,
                          het_fractions, log_priors,
                          coverage_cutoff=(0.02, 0.0001),
                          min_overlap: int = 16, min_pass_gq: int = 10):
    """The whole genotyping step for a batch: likelihoods, best GT, GQ
    (int-truncated like the C++ -10*log10 cast), NO_READS / GQ / BP_DEPTH
    filter flags, allele fractions and the depth test's p-value.

    Mirrors BreakpointGenotyper::genotype (BreakpointGenotyper.cpp:
    86-192) in float32. Shapes: counts [..., A] int32;
    depth / read_length / depth_sd float32 and use_poisson bool [...];
    returns a dict of tensors with leading shape [...] on the inputs'
    device.
    """
    import torch

    gl, best, pr_err = _likelihoods(counts, depth, read_length, gt_ploidy,
                                    error_rates, het_fractions, log_priors,
                                    min_overlap)
    lam = depth * (read_length - min_overlap) / read_length
    total = counts.sum(-1, dtype=torch.int32)
    no_reads = total == 0

    gq_log10 = torch.log10(torch.clamp_min(pr_err, 1e-300))
    gq = torch.where((pr_err <= 0) | (gq_log10 < -10), 100,
                     (-10.0 * gq_log10).to(torch.int32))
    gq_filter = (~no_reads) & (gq < min_pass_gq)

    fractions = counts / torch.clamp_min(total, 1)[..., None]

    totf = total.to(torch.float32)
    normal_p = _normal_sf_upper(totf, lam, depth_sd)
    # P(X <= k) = Q(k+1, lam) (regularized upper incomplete gamma)
    poisson_p = torch.special.gammaincc(totf + 1.0, lam)
    pv = torch.where(use_poisson, poisson_p, normal_p)
    upper = pv > 0.5
    pv_two = torch.where(upper, 1.0 - pv, pv)
    bp_depth = (~no_reads) & torch.where(
        upper, pv_two < coverage_cutoff[0], pv_two < coverage_cutoff[1])

    return {
        "gl": gl, "best_gt": best, "gq": gq, "num_reads": total,
        "allele_fractions": fractions, "coverage_test_pvalue": pv_two,
        "no_reads": no_reads, "gq_filter": gq_filter,
        "bp_depth": bp_depth,
    }


def combined_consensus_batch(best_gt, pass_mask, has_gt):
    """Whole-variant consensus over the breakpoint axis
    (CombinedGenotype.cpp:46-109 fast path): per sample, if every PASS
    breakpoint votes the same genotype the consensus is that genotype;
    otherwise the sample needs the conflict path (re-genotype on summed
    counts), flagged here for the host to resolve.

    best_gt [S, BP] int32; pass_mask / has_gt [S, BP] bool tensors.
    Returns (consensus_gt [S], -1 where unresolved; conflict [S] bool).
    """
    import torch

    votes = torch.where(pass_mask & has_gt, best_gt, -1)
    first = votes.amax(-1)  # a pass vote if any (-1 otherwise)
    agree = ((votes == -1) | (votes == first[..., None])).all(-1)
    any_pass = (votes >= 0).any(-1)
    consensus = torch.where(any_pass & agree, first, -1)
    conflict = any_pass & ~agree
    return consensus, conflict
