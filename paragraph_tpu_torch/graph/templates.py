"""Typed-event graph templates (JSON event list input).

Equivalent of the reference's ``src/python/lib/grm/graph_templates/``:
direct construction of small graphs for del / longdel / swap / longswap /
ins events, dispatched on event size vs 2×flank
(graph_templates/__init__.py:46-76).
"""
from __future__ import annotations

import os


def make_graph(reference: str, event: dict):
    assert os.path.exists(reference)
    flank = event.get("flank", 150)
    ins = event.get("ins", "")
    ref_len = event["end"] - event["start"] + 1
    is_del = ref_len > 0
    assert is_del or len(ins) > 0
    chrom = event["chrom"]
    start = min(event["start"], event["end"])
    end = max(event["start"], event["end"])

    if is_del and not ins:
        if ref_len <= 2 * flank:
            return "del", short_deletion(chrom, start, end, flank)
        return "longdel", long_deletion(chrom, start, end, flank)
    if is_del:
        if ref_len <= 2 * flank:
            return "swap", short_swap(chrom, start, end, ins, flank)
        return "longswap", long_swap(chrom, start, end, ins, flank)
    return "ins", insertion(chrom, start, ins, flank)


def _region(chrom, start, end):
    return f"{chrom}:{start}-{end}"


def short_deletion(chrom, start, end, flank=150):
    """3-node LF/MID/RF deletion graph (shortdeletion.py:20-93)."""
    target_region = _region(chrom, max(1, start - flank - 1), end + flank + 1)
    lf = _region(chrom, max(1, start - flank - 1), start - 1)
    mid = _region(chrom, start, end)
    rf = _region(chrom, end + 1, end + flank + 1)
    return {
        "sequencenames": ["REF", "DEL"],
        "target_regions": [target_region],
        "nodes": [
            {"name": "LF", "reference": lf},
            {"name": "MID", "reference": mid},
            {"name": "RF", "reference": rf},
        ],
        "edges": [
            {"from": "LF", "to": "RF", "sequences": ["DEL"]},
            {"from": "LF", "to": "MID", "sequences": ["REF"]},
            {"from": "MID", "to": "RF", "sequences": ["REF"]},
        ],
        "paths": [
            {"nodes": ["LF", "MID", "RF"], "path_id": "REF|1",
             "sequence": "REF",
             "nucleotide_length": end - start + 1 + 2 * flank},
            {"nodes": ["LF", "RF"], "path_id": "DEL|1", "sequence": "DEL",
             "nucleotide_length": 2 * flank},
        ],
    }


def long_deletion(chrom, start, end, flank=150):
    """Graph for deletions longer than 2×flank: padded MID_L/MID_R pieces
    with explicit source/sink (longdeletion.py:18-136)."""
    assert end - start + 1 >= 2 * flank
    target_region_l = _region(chrom, max(1, start - flank - 1), start + flank + 1)
    target_region_r = _region(chrom, max(1, end - flank - 1), end + flank + 1)
    lf = _region(chrom, max(1, start - flank - 1), max(1, start - 1))
    mid_l = _region(chrom, start, start + flank - 1)
    mid_r = _region(chrom, max(1, end - flank), max(1, end - 1))
    rf = _region(chrom, end + 1, end + flank + 1)
    return {
        "sequencenames": ["REF", "DEL"],
        "target_regions": [target_region_l, target_region_r],
        "nodes": [
            {"name": "source", "sequence": "NNNNN"},
            {"name": "LF", "reference": lf},
            {"name": "MID_L", "reference": mid_l},
            {"name": "MID_R", "reference": mid_r},
            {"name": "RF", "reference": rf},
            {"name": "sink", "sequence": "NNNNN"},
        ],
        "edges": [
            {"from": "source", "to": "LF"},
            {"from": "source", "to": "MID_R"},
            {"from": "LF", "to": "RF", "sequences": ["DEL"]},
            {"from": "LF", "to": "MID_L", "sequences": ["REF"]},
            {"from": "MID_R", "to": "RF", "sequences": ["REF"]},
            {"from": "MID_R", "to": "sink"},
            {"from": "RF", "to": "sink"},
        ],
        "paths": [
            {"nodes": ["LF", "MID_L"], "path_id": "REF|1", "sequence": "REF",
             "nucleotide_length": 2 * flank},
            {"nodes": ["MID_R", "RF"], "path_id": "REF|2", "sequence": "REF",
             "nucleotide_length": 2 * flank},
            {"nodes": ["LF", "RF"], "path_id": "DEL|1", "sequence": "DEL",
             "nucleotide_length": 2 * flank},
        ],
    }


def insertion(chrom, start, ins, flank=150):
    """LF/INS/RF insertion graph (insertion.py:18-87).

    `start` is the last base before the insertion."""
    target_region = _region(chrom, max(1, start - flank - 1), start + flank + 1)
    lf = _region(chrom, max(1, start - flank - 1), max(1, start - 1))
    rf = _region(chrom, start + 1, start + flank + 1)
    return {
        "sequencenames": ["REF", "INS"],
        "target_regions": [target_region],
        "nodes": [
            {"name": "LF", "reference": lf},
            {"name": "INS", "sequence": ins},
            {"name": "RF", "reference": rf},
        ],
        "edges": [
            {"from": "LF", "to": "RF", "sequences": ["REF"]},
            {"from": "LF", "to": "INS", "sequences": ["INS"]},
            {"from": "INS", "to": "RF", "sequences": ["INS"]},
        ],
        "paths": [
            {"nodes": ["LF", "INS", "RF"], "path_id": "INS|1",
             "sequence": "INS", "nucleotide_length": len(ins) + 2 * flank},
            {"nodes": ["LF", "RF"], "path_id": "REF|1", "sequence": "REF",
             "nucleotide_length": 2 * flank},
        ],
    }


def short_swap(chrom, start, end, ins, flank=150):
    """LF/MID/INS/RF swap graph with DEL + INS alleles (shortswap.py)."""
    target_region = _region(chrom, max(1, start - flank - 1), end + flank + 1)
    lf = _region(chrom, max(1, start - flank - 1), max(1, start - 1))
    mid = _region(chrom, start, end)
    rf = _region(chrom, end + 1, end + flank + 1)
    return {
        "sequencenames": ["REF", "DEL", "INS"],
        "target_regions": [target_region],
        "nodes": [
            {"name": "LF", "reference": lf},
            {"name": "MID", "reference": mid},
            {"name": "INS", "sequence": ins},
            {"name": "RF", "reference": rf},
        ],
        "edges": [
            {"from": "LF", "to": "RF", "sequences": ["DEL"]},
            {"from": "LF", "to": "MID", "sequences": ["REF"]},
            {"from": "LF", "to": "INS", "sequences": ["INS"]},
            {"from": "INS", "to": "RF", "sequences": ["INS"]},
            {"from": "MID", "to": "RF", "sequences": ["REF"]},
        ],
        "paths": [
            {"nodes": ["LF", "MID", "RF"], "path_id": "REF|1",
             "sequence": "REF",
             "nucleotide_length": end - start + 1 + 2 * flank},
            {"nodes": ["LF", "RF"], "path_id": "DEL|1", "sequence": "DEL",
             "nucleotide_length": 2 * flank},
            {"nodes": ["LF", "INS", "RF"], "path_id": "INS|1",
             "sequence": "INS", "nucleotide_length": 2 * flank + len(ins)},
        ],
    }


def long_swap(chrom, start, end, ins, flank=150):
    """Swap with long reference interval: padded MID_L/MID_R pieces plus
    source/sink (longswap.py — including the reference's min(1, ...) MID_R
    coordinate quirk, retained for output parity)."""
    assert end - start + 1 >= 2 * flank
    target_region_l = _region(chrom, max(1, start - flank - 1), start + flank + 1)
    target_region_r = _region(chrom, max(1, end - flank - 1), end + flank + 1)
    lf = _region(chrom, max(1, start - flank - 1), start - 1)
    mid_l = _region(chrom, start, start + flank - 1)
    mid_r = _region(chrom, min(1, end - flank), min(1, end - 1))
    rf = _region(chrom, end + 1, end + flank + 1)
    return {
        "sequencenames": ["REF", "DEL", "INS"],
        "target_regions": [target_region_l, target_region_r],
        "nodes": [
            {"name": "source", "sequence": "NNNNN"},
            {"name": "LF", "reference": lf},
            {"name": "MID_L", "reference": mid_l},
            {"name": "INS", "sequence": ins},
            {"name": "MID_R", "reference": mid_r},
            {"name": "RF", "reference": rf},
            {"name": "sink", "sequence": "NNNNN"},
        ],
        "edges": [
            {"from": "source", "to": "LF"},
            {"from": "source", "to": "MID_R"},
            {"from": "LF", "to": "RF", "sequences": ["DEL"]},
            {"from": "LF", "to": "INS", "sequences": ["INS"]},
            {"from": "INS", "to": "RF", "sequences": ["INS"]},
            {"from": "LF", "to": "MID_L", "sequences": ["REF"]},
            {"from": "MID_R", "to": "RF", "sequences": ["REF"]},
            {"from": "MID_R", "to": "sink"},
            {"from": "RF", "to": "sink"},
        ],
        "paths": [
            {"nodes": ["LF", "MID_L"], "path_id": "REF|1", "sequence": "REF",
             "nucleotide_length": 2 * flank},
            {"nodes": ["MID_R", "RF"], "path_id": "REF|2", "sequence": "REF",
             "nucleotide_length": 2 * flank},
            {"nodes": ["LF", "RF"], "path_id": "DEL|1", "sequence": "DEL",
             "nucleotide_length": 2 * flank},
            {"nodes": ["LF", "INS", "RF"], "path_id": "INS|1",
             "sequence": "INS", "nucleotide_length": 2 * flank + len(ins)},
        ],
    }
