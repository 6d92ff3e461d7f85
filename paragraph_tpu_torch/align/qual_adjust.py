"""Base-quality-adjusted scoring matrices (gssw capability surface).

Re-derivation of gssw's quality adjustment
(the reference's external/gssw/gssw.c:4254-4556): interpret the integer
match/mismatch matrix as Karlin-Altschul log-odds scores, recover the
log base λ by bisecting the alignment partition function to 1, then for
each Phred quality q mix the aligned-emission probabilities with the
base-error complement and convert back to integer scores. The scaled
variant multiplies scores (and the gap penalties) by the largest
integer multiplier that keeps everything under max_score, which
sharpens the quantization of the per-quality adjustments.

tests/test_qual_adjust.py checks byte-exact parity against the compiled
reference gssw for the DNA wrapper.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def score_gcf(mat: np.ndarray) -> int:
    """Greatest common factor of all |scores| — with the reference's
    exact loop bound, which stops at min_score/2 and so never tries
    min_score itself (gssw.c:4244-4279)."""
    vals = np.abs(mat.astype(np.int64)).ravel().copy()
    min_score = int(vals.min())
    gcf = 1
    factor = 2
    while factor <= min_score // 2:
        if np.all(vals % factor == 0):
            gcf *= factor
            vals //= factor
            min_score //= factor
        else:
            factor += 1
    return gcf


def _partition(lam: float, mat: np.ndarray, freqs: np.ndarray) -> float:
    return float(np.sum(np.outer(freqs, freqs) * np.exp(lam * mat)))


def recover_log_base(mat: np.ndarray, freqs: np.ndarray,
                     tol: float = 1e-12) -> float:
    """Bisection for λ with partition(λ) = 1 (gssw.c:4297-4343)."""
    has_pos = np.any(mat > 0)
    expected = float(np.sum(np.outer(freqs, freqs) * mat))
    if not has_pos or expected >= 0:
        raise ValueError(
            "score matrix does not correspond to log-odds of any "
            "distribution")
    lam = 1.0
    p = _partition(lam, mat, freqs)
    if p < 1.0:
        lower = lam
        while p <= 1.0:
            lower = lam
            lam *= 2.0
            p = _partition(lam, mat, freqs)
        upper = lam
    else:
        upper = lam
        while p >= 1.0:
            upper = lam
            lam /= 2.0
            p = _partition(lam, mat, freqs)
        lower = lam
    while upper / lower - 1.0 > tol:
        lam = 0.5 * (lower + upper)
        if _partition(lam, mat, freqs) < 1.0:
            lower = lam
        else:
            upper = lam
    return 0.5 * (lower + upper)


def _round8(x: float) -> int:
    """gssw_round8_t: round half away from zero via C truncation."""
    i = int(x)  # truncates toward zero like the (int8_t) cast
    if x >= 0.0:
        return i + 1 if x - i >= 0.5 else i
    return i - 1 if i - x >= 0.5 else i


def adjusted_qual_matrix(max_qual: int, mat: np.ndarray,
                         freqs: np.ndarray,
                         tol: float = 1e-12) -> np.ndarray:
    """[max_qual+1, A, A] quality-adjusted scores (gssw.c:4391-4454)."""
    mat = np.asarray(mat, np.int64)
    freqs = np.asarray(freqs, np.float64)
    a = mat.shape[0]
    gcf = score_gcf(mat)
    lam = recover_log_base(mat // gcf, freqs, tol) / gcf

    align_prob = np.exp(lam * mat) * np.outer(freqs, freqs)  # [A, A]
    # emission probability mass on the OTHER query bases, per (i, j)
    complement = align_prob.sum(axis=1, keepdims=True) - align_prob

    lowest_q = _round8(-10.0 * math.log10(1.0 - 1.0 / a))
    out = np.zeros((max_qual + 1, a, a), np.int64)
    for q in range(lowest_q, max_qual + 1):
        err = 10.0 ** (-q / 10.0)
        num = (1.0 - err) * align_prob + (err / (a - 1.0)) * complement
        den = freqs[:, None] * ((1.0 - err) * freqs[None, :]
                                + (err / (a - 1.0))
                                * (1.0 - freqs[None, :]))
        score = np.log(num / den) / lam
        out[q] = np.vectorize(_round8)(score)
    return out


def scaled_adjusted_qual_matrix(max_score: int, max_qual: int,
                                gap_open: int, gap_extend: int,
                                mat: np.ndarray, freqs: np.ndarray,
                                tol: float = 1e-12
                                ) -> Tuple[np.ndarray, int, int]:
    """Scaled variant (gssw.c:4456-4499): returns (matrix,
    scaled_gap_open, scaled_gap_extend)."""
    mat = np.asarray(mat, np.int64)
    multiplier = abs(max_score)
    # C semantics: integer division truncating toward zero
    for div in (gap_open, gap_extend, *mat.ravel().tolist()):
        m = abs(int(max_score / div)) if div else multiplier
        if m < multiplier:
            multiplier = m
    if multiplier == 0:
        raise ValueError("max scaled score smaller than baseline score")
    adj = adjusted_qual_matrix(max_qual, mat * multiplier, freqs, tol)
    return adj, multiplier * gap_open, multiplier * gap_extend


def dna_scaled_adjusted_qual_matrix(max_score: int, max_qual: int,
                                    gap_open: int, gap_extend: int,
                                    match: int, mismatch: int,
                                    gc_content: float,
                                    tol: float = 1e-12
                                    ) -> Tuple[np.ndarray, int, int]:
    """DNA wrapper with a 0-scoring N row/column appended
    (gssw.c:4501-4556). Matrix shape [max_qual+1, 5, 5]."""
    gc = gc_content / 2.0
    at = 0.5 - gc
    freqs = np.array([at, gc, gc, at])
    mat = np.full((4, 4), -mismatch, np.int64)
    np.fill_diagonal(mat, match)
    adj, go, ge = scaled_adjusted_qual_matrix(
        max_score, max_qual, gap_open, gap_extend, mat, freqs, tol)
    aug = np.zeros((max_qual + 1, 5, 5), np.int64)
    aug[:, :4, :4] = adj
    return aug, go, ge
