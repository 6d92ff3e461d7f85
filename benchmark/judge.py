"""The comparisons that decide ``correct``: the program's outputs against
the reference's (``reference.py``), as numbers each held to a limit of
its configuration's ``limits``.

multigrmpy cells, per checked (event, sample), over every job of the
window:
- ``calls_differ``: items that differ among each breakpoint's allele
  read counts, GT, GQ and filters, and the sample's GT, GQ and filters;
- ``gl_gap``: the widest gap between a GL of the program and the
  reference's.
All against refpipe's float64 host engine. A program that genotypes in
float32 (``float32_program``) may give another GQ only where float32
cannot resolve GQ's error probability, 1 - exp(best) / sum(exp(GL)): where
the reference's is under GQ_ULPS float32 ulps of the best GL, float32
rounds it to 0 or a few ulps, and GQ to anything from ``gq_floor`` up to
the cap of 100. Such a GQ counts as ``gq_rounded`` on the detail line,
not in ``calls_differ``; nothing else is exempted.
realign cell: ``k1_outputs_differ``, the (read orientation, output)
values among score, end node, end offset, end row and multi flag that
differ, over every pass of the window over the checked events.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


def _gt_items(gt: dict):
    return gt.get("GT"), gt.get("GQ"), sorted(gt.get("filters", []))


def _gl_gap(a: dict, b: dict) -> float:
    ga, gb = a.get("GL", {}), b.get("GL", {})
    if set(ga) != set(gb):
        return math.inf
    gaps = [abs(ga[k] - gb[k]) for k in ga]
    # a GL that is NaN on one side is as far off as one can be
    return max((math.inf if math.isnan(g) else g for g in gaps),
               default=0.0)


#: float32 ulps of the best GL under which GQ's error probability is not
#: resolved; on an H100 every GQ of the device engine that differed from
#: the float64 engine's had it under 4.5 ulps
GQ_ULPS = 8


def float32_program(cfg: dict) -> bool:
    """Whether the configuration's program genotypes in float32: its
    ``gt_engine`` names the device engine. "auto" is judged as float64,
    so a configuration whose "auto" takes the engine has to name it."""
    return cfg["options"].get("gt_engine") == "device"


def gq_floor(gt: dict) -> Optional[int]:
    """The lowest GQ that float32 may give for the reference's genotype
    record `gt`, where its GQ's error probability is under GQ_ULPS float32
    ulps of its best GL: that of the error probability plus those ulps;
    None where float32 resolves it."""
    gl = list(gt.get("GL", {}).values())
    if len(gl) < 2 or not math.isfinite(max(gl)):
        return None
    best = max(gl)
    pr_err = -math.expm1(-math.log(sum(math.exp(g - best) for g in gl)))
    ulps = GQ_ULPS * float(np.spacing(np.float32(abs(best))))
    if pr_err > ulps:
        return None
    return int(-10 * math.log10(pr_err + ulps))


def _items_differ(rg: dict, pg: dict, float32: bool) -> Tuple[int, int]:
    """(differing items of GT, GQ and filters, GQs that float32 rounds)."""
    calls = rounded = 0
    for name, x, y in zip(("GT", "GQ", "filters"), _gt_items(rg),
                          _gt_items(pg)):
        if x == y:
            continue
        low = gq_floor(rg) if float32 and name == "GQ" else None
        if low is not None and isinstance(y, int) and low <= y <= 100:
            rounded += 1
        else:
            calls += 1
    return calls, rounded


def compare_samples(prog: dict, ref: dict, float32: bool = False
                    ) -> Dict[str, float]:
    """Numbers of one event: `prog` and `ref` are its records' "samples"
    dicts ({sample: record}). With `float32` (a program that genotypes in
    float32), a GQ that float32 rounds counts as ``gq_rounded``."""
    calls = rounded = 0
    gap = 0.0
    for name, r in ref.items():
        p = prog.get(name)
        if p is None:
            calls += 1
            gap = math.inf
            continue
        rb, pb = r.get("breakpoints", {}), p.get("breakpoints", {})
        gts = [(r.get("gt", {}), p.get("gt", {}))]
        for bp in set(rb) | set(pb):
            if bp not in rb or bp not in pb:
                calls += 1
                gap = math.inf
                continue
            calls += (rb[bp]["counts"]["alleles"]
                      != pb[bp]["counts"]["alleles"])
            gts.append((rb[bp].get("gt", {}), pb[bp].get("gt", {})))
        for rg, pg in gts:
            c, k = _items_differ(rg, pg, float32)
            calls, rounded = calls + c, rounded + k
            gap = max(gap, _gl_gap(rg, pg))
    out = {"calls_differ": calls, "gl_gap": gap}
    if float32:
        out["gq_rounded"] = rounded
    return out


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
