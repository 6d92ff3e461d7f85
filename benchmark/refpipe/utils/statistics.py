"""Statistics helpers: robust Gaussian fits and streaming quantiles.

Equivalents of the reference's statistics library
(the reference's src/c++/lib/statistics/): ``MinCovDetGaussian`` (minimum
covariance determinant mean/variance fit used by depth estimation) and
``NaiveGaussian``, plus the P² streaming quantile estimator that backs
boost's accumulator ``tag::median`` used throughout the reference.
"""
from __future__ import annotations

import math
from typing import List, Sequence


def mean(nums: Sequence[float]) -> float:
    return sum(nums) / len(nums) if nums else float("nan")


def variance_population(nums: Sequence[float]) -> float:
    if not nums:
        return float("nan")
    m = mean(nums)
    return sum((x - m) ** 2 for x in nums) / len(nums)


class NaiveGaussian:
    """statistics::NaiveGaussian: plain mean/variance fit. Variance is the
    sample variance (basics::one_pass_mean_var divides by n-1,
    Basics.hh:118-139)."""

    def __init__(self):
        self.mean = float("nan")
        self.variance = float("nan")

    def fit(self, nums: Sequence[float]):
        self.mean = mean(nums)
        n = len(nums)
        self.variance = (variance_population(nums) * n / (n - 1)
                         if n > 1 else 0.0)

    def standard_deviation(self) -> float:
        return math.sqrt(self.variance)


# chi²(1 dof) complement quantiles, the static factors in
# MinCovDetGaussian.cpp:241-252 (boost::math::quantile(complement(...)))
_CHI2_1_MEDIAN = 0.45493642311957424  # isf(0.5)
_CHI2_1_MASK = 5.023886187314888      # isf(0.025)


def _median(nums: Sequence[float]) -> float:
    """basics::median (Basics.hh:52-82): sorted midpoint, mean of the two
    middle elements for even sizes."""
    s = sorted(nums)
    n = len(s)
    if n % 2:
        return float(s[n // 2])
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


class MinCovDetGaussian:
    """statistics::MinCovDetGaussian (MinCovDetGaussian.cpp:44-266):
    univariate MCD — raw fit on the shortest contiguous n_support window
    of the sorted data, then sklearn-style chi² reweighting: squared
    z-scores are scaled so their median matches the chi²(1) median, and
    the final mean/variance are refit on the observations whose corrected
    z² pass the 97.5% chi²(1) mask."""

    def __init__(self, raw_support_frac: float = 0.5):
        if not (0.5 <= raw_support_frac <= 1):
            raise ValueError("support fraction must be in [0.5, 1]")
        self.raw_support_frac = raw_support_frac
        self.mean = float("nan")
        self.variance = float("nan")
        self.raw_mean = float("nan")
        self.raw_variance = float("nan")
        self.support: List[float] = []

    def raw_support_fraction(self) -> float:
        return self.raw_support_frac

    def fit(self, nums: Sequence[float]):
        n = len(nums)
        support_frac = max(1.0 / n + 0.5, self.raw_support_frac)
        n_support = math.ceil(n * support_frac)
        if n_support < n:
            sorted_nums = sorted(nums)
            diffs = [
                sorted_nums[i + n_support] - sorted_nums[i]
                for i in range(n - n_support)
            ]
            min_diff = min(diffs)
            idxs = [i for i, d in enumerate(diffs) if d == min_diff]
            self.raw_mean = 0.5 * mean([
                sorted_nums[i] + sorted_nums[i + n_support] for i in idxs])
            order = sorted(range(n),
                           key=lambda i: abs(nums[i] - self.raw_mean))
            var_nums = [nums[i] for i in order[:n_support]]
            self.raw_variance = variance_population(var_nums)
        else:
            self.raw_mean = mean(nums)
            self.raw_variance = variance_population(nums)

        # chi² reweighting (MinCovDetGaussian.cpp:237-266)
        if self.raw_variance > 0:
            z2 = [(x - self.raw_mean) ** 2 / self.raw_variance
                  for x in nums]
        else:
            z2 = [0.0 for _ in nums]
        correction = _median(z2) / _CHI2_1_MEDIAN
        self.support = [
            x for x, z in zip(nums, z2)
            if correction > 0 and abs(z / correction) < _CHI2_1_MASK]
        if self.support:
            self.mean = mean(self.support)
            self.variance = variance_population(self.support)
        else:
            self.mean = float("nan")
            self.variance = float("nan")


class P2Quantile:
    """P² streaming quantile (Jain & Chlamtac 1985), the algorithm behind
    boost::accumulators tag::median / p_square_quantile."""

    def __init__(self, p: float = 0.5):
        self.p = p
        self.heights: List[float] = []
        self.actual = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.desired = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
        self.increments = [0.0, p / 2, p, (1 + p) / 2, 1.0]
        self.count = 0

    def add(self, x: float):
        self.count += 1
        if self.count <= 5:
            self.heights.append(x)
            if self.count == 5:
                self.heights.sort()
            return
        h = self.heights
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if h[i] <= x:
                    k = i
        for i in range(k + 1, 5):
            self.actual[i] += 1
        for i in range(5):
            self.desired[i] += self.increments[i]
        for i in range(1, 4):
            d = self.desired[i] - self.actual[i]
            if ((d >= 1 and self.actual[i + 1] - self.actual[i] > 1)
                    or (d <= -1 and self.actual[i - 1] - self.actual[i] < -1)):
                d = 1.0 if d >= 0 else -1.0
                # parabolic prediction
                hp = h[i] + d / (self.actual[i + 1] - self.actual[i - 1]) * (
                    (self.actual[i] - self.actual[i - 1] + d)
                    * (h[i + 1] - h[i])
                    / (self.actual[i + 1] - self.actual[i])
                    + (self.actual[i + 1] - self.actual[i] - d)
                    * (h[i] - h[i - 1])
                    / (self.actual[i] - self.actual[i - 1]))
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # linear
                    j = i + int(d)
                    h[i] = h[i] + d * (h[j] - h[i]) / (
                        self.actual[j] - self.actual[i])
                self.actual[i] += d

    def value(self) -> float:
        if self.count == 0:
            return 0.0
        if self.count <= 5:
            s = sorted(self.heights)
            return s[min(len(s) - 1, int(len(s) * self.p))]
        return self.heights[2]
