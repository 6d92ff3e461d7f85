"""The kernel yardstick of the realign cell, frozen here so that a change
to the program's tables or kernels cannot move it.

Needed cells: each read's length times the bases of its event's graph
(every node once), times its four orientations; 8 int32 operations a
cell (two for H, one for H - gap open, one each for E and the next
row's F, two for the end-cell word and its maximum, one for the node
maximum: the argument of ``chip_smoke.py``'s bound). The operations
bound is those operations over SMs x 64 INT32 lanes at the card's
maximum SM clock; the bytes bound is the reads' bases, the graphs'
bases (as 4-byte column words, both directions) and the outputs (four
int32 per orientation) once each, at 3.35 TB/s. The least time is the
larger bound; the share is that over the measured kernel time.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional, Sequence

OPS_PER_CELL = 8
INT32_LANES_PER_SM = 64
#: NVIDIA's data sheet, H100 SXM
HBM_BYTES_PER_S = 3.35e12


def graph_bases(graph_json: dict) -> int:
    """Bases of one graph of the benchmark's graphs.json."""
    total = 0
    for n in graph_json["nodes"]:
        if "sequence" in n:
            total += len(n["sequence"])
        else:
            lo, hi = n["reference"].split(":")[1].split("-")
            total += int(hi) - int(lo) + 1
    return total


def needed_work(read_lens: Sequence[Sequence[int]],
                bases: Sequence[int]) -> Dict[str, int]:
    """Cells, operations and bytes of one pass over events whose reads
    have lengths read_lens[e] and whose graphs have bases[e]."""
    cells = 0
    nbytes = 0
    for lens, b in zip(read_lens, bases):
        n_bases = int(sum(lens))
        cells += 4 * n_bases * b
        nbytes += n_bases + 2 * 4 * b + 4 * 4 * 4 * len(lens)
    return {"cells": cells, "ops": OPS_PER_CELL * cells, "bytes": nbytes}


def card_peaks(device_index: int = 0) -> Dict[str, float]:
    """SM count, maximum SM clock and power limit of the card, read in this
    run; the operations and bytes peaks."""
    import torch

    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", f"--id={device_index}",
         "--query-gpu=clocks.max.sm,power.limit", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    clock_mhz, power_w = (float(x) for x in out.stdout.strip().split(","))
    return {"sms": sms, "max_sm_clock_mhz": clock_mhz,
            "power_limit_w": power_w,
            "int32_ops_per_s": sms * INT32_LANES_PER_SM * clock_mhz * 1e6,
            "bytes_per_s": HBM_BYTES_PER_S}


def roofline_share(work: Dict[str, int], peaks: Dict[str, float],
                   kernel_s: float) -> Optional[Dict[str, float]]:
    """Share (%) of the least time over the measured kernel time, and
    which bound sets it; None when no kernel time was measured."""
    if kernel_s <= 0 or work["ops"] <= 0:
        return None
    t_ops = work["ops"] / peaks["int32_ops_per_s"]
    t_bytes = work["bytes"] / peaks["bytes_per_s"]
    least = max(t_ops, t_bytes)
    return {"share_pct": 100.0 * least / kernel_s,
            "bound": "operations" if t_ops >= t_bytes else "bytes",
            "least_s": least, "kernel_s": kernel_s}
