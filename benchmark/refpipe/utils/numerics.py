"""Numeric helpers for C++-compatible arithmetic.

The reference mixes float32 parameters (e.g. ``bad_align_frac``,
paragraph/Parameters.hh) with C ``round`` (half away from zero); Python's
banker's rounding and float64 literals would diverge on boundaries.
"""
from __future__ import annotations

import math

import numpy as np


def c_round(x: float) -> int:
    """C/C++ round(): half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def f32(x: float) -> float:
    """Round-trip through IEEE float32 (C++ ``float`` literals/params)."""
    return float(np.float32(x))
