"""The comparisons that decide ``correct``: the program's outputs against
the reference's (``reference.py``), as numbers each held to a limit of
its configuration's ``limits``.

multigrmpy cells, per checked (event, sample), over every job of the
window:
- ``calls_differ``: items that differ among each breakpoint's allele
  read counts, GT, GQ and filters, and the sample's GT, GQ and filters;
- ``gl_gap``: the widest gap between a GL of the program and the
  reference's.
realign cell: ``k1_outputs_differ``, the (read orientation, output)
values among score, end node, end offset, end row and multi flag that
differ, over every pass of the window over the checked events.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np


def _gt_items(gt: dict):
    return gt.get("GT"), gt.get("GQ"), sorted(gt.get("filters", []))


def _gl_gap(a: dict, b: dict) -> float:
    ga, gb = a.get("GL", {}), b.get("GL", {})
    if set(ga) != set(gb):
        return math.inf
    return max((abs(ga[k] - gb[k]) for k in ga), default=0.0)


def compare_samples(prog: dict, ref: dict) -> Dict[str, float]:
    """Numbers of one event: `prog` and `ref` are its records' "samples"
    dicts ({sample: record})."""
    calls = 0
    gap = 0.0
    for name, r in ref.items():
        p = prog.get(name)
        if p is None:
            calls += 1
            gap = math.inf
            continue
        rb, pb = r.get("breakpoints", {}), p.get("breakpoints", {})
        for bp in set(rb) | set(pb):
            if bp not in rb or bp not in pb:
                calls += 1
                gap = math.inf
                continue
            calls += (rb[bp]["counts"]["alleles"]
                      != pb[bp]["counts"]["alleles"])
            rg, pg = rb[bp].get("gt", {}), pb[bp].get("gt", {})
            calls += sum(x != y for x, y in zip(_gt_items(rg),
                                                 _gt_items(pg)))
            gap = max(gap, _gl_gap(rg, pg))
        rg, pg = r.get("gt", {}), p.get("gt", {})
        calls += sum(x != y for x, y in zip(_gt_items(rg), _gt_items(pg)))
        gap = max(gap, _gl_gap(rg, pg))
    return {"calls_differ": calls, "gl_gap": gap}


def fold(numbers: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Sum the counts and take the widest gap over several comparisons."""
    out: Dict[str, float] = {}
    for n in numbers:
        for k, v in n.items():
            if k.endswith("_gap"):
                out[k] = max(out.get(k, 0.0), v)
            else:
                out[k] = out.get(k, 0) + v
    return out


K1_FIELDS = ("score", "end_node", "end_ref", "end_read", "multi")


def compare_k1(prog: Tuple, ref: Tuple) -> int:
    """Differing values between one event's program outputs (f_out, r_out
    5-tuples in K1_FIELDS order) and the reference's (f_out, r_out dicts
    of reference.four_orientations)."""
    bad = 0
    for p_out, r_out in zip(prog, ref):
        for k, name in enumerate(K1_FIELDS):
            p = np.asarray(p_out[k])
            r = np.asarray(r_out[name])
            if p.shape != r.shape:
                bad += max(p.size, r.size)
            else:
                bad += int((p != r).sum())
    return bad


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number within its limit, [(name, number, limit)])."""
    rows = [(k, numbers[k], limits[k]) for k in sorted(numbers)]
    return all(v <= lim for _, v, lim in rows), rows
