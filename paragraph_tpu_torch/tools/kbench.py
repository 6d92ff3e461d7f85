"""Kernel-only timing of the paired graph-SW kernel (K1) on one bench-shaped
dispatch.

Counterpart of the JAX package's ``tools/kbench.py`` and of
``bench.py::build_case``: the tables of one dispatch (a ~600-base
deletion graph with source and sink, 8,192 reads of 150 bp with 1%
substitutions, so 32,768 lanes in 256 tiles of 128) are built once and
placed on the device; the fill is then timed alone, as one dispatch and
as dispatches queued back to back. On ``cuda`` times come from CUDA
events around the launches; on ``cpu`` (the plain fill) from the host
clock.

    python -m paragraph_tpu_torch.tools.kbench [--device cuda]
        [--iters 10] [--reads 8192]
    python3 paragraph_tpu_torch/tools/kbench.py ...   (the same)

Prints the shapes on stderr and one JSON line: ``single_dispatch_s``
(best of 5), ``queued_per_dispatch_s``, ``cells`` (issued: columns x
lanes x read rows), ``gcells_single``, ``gcells_queued`` and the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    # run by path: import the package from the checkout this file is in
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "paragraph_tpu_torch.tools"

#: read length of the bench's reads
READ_LEN = 150
#: reads of the bench's dispatch (16,384 orientations per graph direction)
N_READS = 8192


def build_case(read_len: int = READ_LEN, n_reads: int = N_READS,
               seed: int = 7):
    """The bench's seeded case: a shortdeletion-style graph (source, two
    150-base flanks around a 300-base deleted interval, sink) and n_reads
    reads from its reference and deletion alleles in turn, with 1%
    substitutions."""
    from ..graph.model import SequenceGraph

    rng = np.random.RandomState(seed)
    bases = "ACGT"

    def seq(n):
        return "".join(bases[i] for i in rng.randint(0, 4, n))

    g = SequenceGraph(
        ["source", "LF", "MID", "RF", "sink"],
        ["X", seq(150), seq(300), seq(150), "X"])
    for f, t in [(0, 1), (1, 2), (1, 3), (2, 3), (3, 4)]:
        g.add_edge(f, t)

    ref = g.node_seq(1) + g.node_seq(2) + g.node_seq(3)
    alt = g.node_seq(1) + g.node_seq(3)
    reads = []
    for i in range(n_reads):
        src = ref if i % 2 == 0 else alt
        start = rng.randint(0, len(src) - read_len)
        read = list(src[start:start + read_len])
        for j in range(len(read)):
            if rng.random_sample() < 0.01:
                read[j] = bases[rng.randint(0, 4)]
        reads.append("".join(read))
    return g, reads


def build(n_reads: int = N_READS, read_len: int = READ_LEN, seed: int = 7,
          device="cuda"):
    """(PairedGraphSW over the bench graph on `device`, the reads)."""
    from ..ops.multi_sw import PairedGraphSW

    g, reads = build_case(read_len=read_len, n_reads=n_reads, seed=seed)
    return PairedGraphSW([g], device=device), reads


def bench_tables(sw, reads):
    """(FillTables, host tables) of the one paired dispatch of `reads`
    against the scorer's first chunk, on the scorer's device."""
    from ..ops.multi_sw import (TILE_LANES, build_pair_tables,
                                dispatch_tables, graph_tensors)

    a = sw.chunk_arrays[0]
    t = build_pair_tables(a, [reads], TILE_LANES)
    return dispatch_tables(t, *graph_tensors(a, sw.device), sw.device), t


def issued_cells(t: dict, m: int) -> int:
    """Issued DP cells of a dispatch: each tile's columns x its lanes x
    `m` read rows."""
    lanes = len(t["col_idx"]) // len(t["tile_col_len"])
    return int(t["tile_col_len"].astype(np.int64).sum()) * lanes * m


def time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of `fn()` over `reps` calls run back to back: CUDA
    events around them on a CUDA device, the host clock on the CPU."""
    import torch

    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    from .. import resolve_device
    from ..ops.multi_sw import paired_fill

    ap = argparse.ArgumentParser("kbench")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sw, reads = build(n_reads=args.reads, device=device)
    tables, t = bench_tables(sw, reads)

    def once():
        return paired_fill(tables)

    once()  # warm-up (and the kernels' build on first use)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    cells = issued_cells(t, t["m"])
    a = sw.chunk_arrays[0]
    print(f"tiles={len(t['tile_event'])} M={t['m']} "
          f"TB={len(t['col_idx']) // len(t['tile_event'])} "
          f"L={len(a.ref_codes)} L_ev={t['l_ev']} N={a.n_max} P={a.p_max} "
          f"cells/dispatch={cells:.3e}", file=sys.stderr)

    single = min(time_ms(once, 1, device) for _ in range(5)) / 1e3
    queued = time_ms(once, args.iters, device) / 1e3
    print(json.dumps({
        "single_dispatch_s": single,
        "queued_per_dispatch_s": queued,
        "cells": cells,
        "gcells_single": cells / single / 1e9,
        "gcells_queued": cells / queued / 1e9,
        "device": device_name(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
