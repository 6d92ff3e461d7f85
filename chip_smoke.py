#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (paragraph_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: torch / CUDA versions and the card's name and power limit
   (nvidia-smi); requires torch.cuda.is_available().
2. build: nvcc builds the kernels from paragraph_tpu_torch/ops/csrc/
   (first use; one nvcc per source, started together), with each
   kernel's registers and spills from ptxas (K4's per variant at R=5 and
   R=26; a spill in any instantiation fails the run), K1's, K2's and
   K3's resident warps per SM at M=160 and M=800, and each K4 variant's
   at M=160 (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
3. K1 kernel vs plain: seeded random cases (N bases, read lengths 6-150,
   empty pairs, pad tiles, reads longer than the graph, int16 and int32
   col_idx), a long-read case (reads of 480-800 bases, M >= 512) and one
   full-size dispatch (the first dispatch of phase 4's first round) go
   through the paired kernel and the plain PyTorch fill on the same CUDA
   tensors; the [4, B] outputs must be identical (tolerance 0: integer DP
   outputs). Times both at the full-size shape, with the bound.
4. main path: the port's multigrmpy with device="cuda" on the repo's
   end-to-end workload (tests/tools/make_workload.py: 1000 mixed
   DEL/INS/DUP/INV/DEL+SNP events, 30x, 150 bp pairs, one sample, seed
   1; generated into smoke_workload/ by that script's command line in a
   subprocess, since it uses the JAX package's BGZF reader, and reused;
   this process reads its truth.json). Requires paired kernel
   launches on that run, zero unexpected misses against the planted
   truth (bench_e2e.check_truth) and the native traceback library.
5. kernel path == plain path end to end: the first 16 events through
   the port on cuda and on cpu give identical genotypes JSON and VCF
   records.
6. K3 kernel vs plain: the single-graph kernel and its plain fill on
   the same CUDA tensors over phase 3's seeded graphs (N bases, read
   lengths 6-150, reads longer than the graph, a single read, lane
   counts that are not multiples of 32), a case whose scores overflow
   the JAX scorer's packed word (match=100000), phase 3's long-read
   graphs, and one full-size dispatch: the largest-graph event of the
   first 200, its extracted reads repeated to 10,000, as the forward
   batch of 20,000 orientations. Outputs identical; times both, with the
   bound, at that size and at the event's own read count.
7. per-event path: the first 200 events through the port's run_grmpy
   with batch_events=False on cuda (the single-graph kernel, twice per
   (event, sample) with reads; no paired launch), then genotypes.json.gz
   and the VCF as multigrmpy writes them. Requires zero unexpected
   misses, and genotypes equal to the batch path's (the paired kernel)
   apart from the engine marker.
8. paragraph CLI: 3 event graphs through the port's `paragraph` tool on
   cuda and on cpu give the same JSON apart from the engine marker.
9. K2 kernel vs plain: MultiGraphSW on cuda and on cpu over phase 3's
   seeded cases, unchunked and chunked (col_budget=64), give identical
   outputs; the multi kernel and its plain fill are timed on the
   largest case's tables.
10. K4 kernel vs plain: the twelve ablation variants of K1's column step
   on its warp-per-lane layout (ops/csrc/kbench_warp.cuh behind
   ops/csrc/kbench_sw.cu and paragraph_tpu_torch/tools/kbench2.py) over
   phase 3's seeded cases (without many_pairs) as MultiGraphSW lays them
   out, a case of reads with many indels, and the bench dispatch of
   tools/kbench.py (8,192 reads, 32,768 lanes, M=160): each variant's
   kernel == its plain fill, every exact variant == v0 == the multi
   kernel, every inexact variant differs from v0 on some case. Then the
   kernel benchmark path (kbench2.time_variants over 4 code buffers) per
   TPU kernel body: each variant's time, its share of the bound and the
   time PERF.md holds for the thread-per-lane design it replaced; the
   multi kernel on the same buffers, against opt1_iprof (K2's body); and
   v0's plain fill once.

Each kernel's launches are counted on its own path, with the counts set
to 0 just before it and read just after: the paired kernel on phase 4,
the single-graph kernel on phase 7, the multi kernel on phase 9's cuda
runs, the ablation kernel on phase 10's timing of each TPU body's
variants. The process refuses to import jax and the JAX package. The
last three lines are the card's name and power limit, then {"kernels":
[...]} (paired_sw, graph_sw, multi_sw and one kbench_sw entry per TPU
kernel body of tools/kbench2.py, each with its bound: the larger of the
int32 operations (DPX fused) the needed cells take on the card's INT32
lanes at the maximum SM clock and the bytes of its tensors at the memory
rate), then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import gzip
import json
import os
import random
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKLOAD = os.path.join(ROOT, "smoke_workload")
N_EVENTS = 1000
DEPTH = 30
SEED = 1
EQ_EVENTS = 16
PER_EVENT_EVENTS = 200
CLI_EVENTS = 3
FULL_READS = 10000
KERNEL_SOURCE = "paragraph_tpu_torch/ops/csrc/paired_sw.cu"
KERNEL_REPLACES = "paragraph_tpu/ops/multi_sw.py:135"
GRAPH_SOURCE = "paragraph_tpu_torch/ops/csrc/graph_sw.cu"
GRAPH_REPLACES = "paragraph_tpu/ops/pallas_sw.py:91"
MULTI_REPLACES = "paragraph_tpu/ops/multi_sw.py:280"
KBENCH_SOURCE = "paragraph_tpu_torch/ops/csrc/kbench_sw.cu"
#: the long-read cases of phases 3 and 6: reads of 480-800 bases, so M up
#: to LONG_M read rows (25 and 26 rows per thread in the warp-per-lane
#: kernels)
LONG_READS = (480, 800)
LONG_M = 800
#: the TPU kernel bodies of tools/kbench2.py and the exact variant of each
#: that phase 10 reports
KBENCH_BODIES = {"make_kernel": ("tools/kbench2.py:35", "v0"),
                 "make_kernel_opt": ("tools/kbench2.py:268", "opt1"),
                 "make_kernel_opt2": ("tools/kbench2.py:407", "opt2")}
#: the bench dispatch (tools/kbench.py): reads, read length, code buffers
KBENCH_READS = 8192
KBENCH_READ_LEN = 150
KBENCH_BUFFERS = 4
#: the bound's model of the fill: the int32 operations one DP cell needs
#: with Hopper's DPX instructions, each counted as one operation at the
#: INT32 rate. H = max(diag + prof, E, F, 0) takes two (a max, then
#: __viaddmax_s32_relu); t = H - gapO one; E' = max(E - gapE, t) and the
#: next row's F = max(F - gapE, t, 0) one __viaddmax each; the end-cell
#: word (H << s) + k and its max two; the node max one. The profile is a
#: table read and the row term k the loop counter, so neither is counted;
#: neither is the seeding at node starts. Then INT32 lanes per SM, and the
#: card's memory rate (NVIDIA's data sheet, H100 SXM).
OPS_PER_CELL = 8
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
#: ms per bench dispatch of each K4 variant, and of K2, in the
#: thread-per-lane design that the warp-per-lane one replaced (PERF.md:
#: v0, opt1 and opt2 from its kernel table, the others from its ladder's
#: chip_smoke.py column; NVIDIA H100 80GB HBM3, 700.00 W)
THREAD_PER_LANE_MS = {
    "v0": 47.856, "nof": 47.570, "notrack": 43.215, "nobranch": 26.196,
    "hoist": 48.145, "unroll2": 48.412, "hoist_u2": 48.112,
    "opt1": 26.326, "opt1_iprof": 18.338, "opt1_nof": 25.897,
    "opt2": 28.489, "opt2_nof": 25.585, "multi_sw": 20.055}


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1


def phase_device() -> str:
    import torch

    import paragraph_tpu_torch  # noqa: F401 (fails outside the repo)

    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")
    return card


# ---------------------------------------------------------------- phase 2


def ptxas_report(log: str):
    """(kernel, registers, spilled bytes) of every entry function in
    nvcc's -Xptxas -v output, labelled by their rows per thread R
    (graph_sw R, paired_sw R, multi_sw R for the paired kernel with the
    orientation expansion off, kbench_sw <variant> R)."""
    from paragraph_tpu_torch.tools.kbench2 import VARIANTS

    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(graph_sw|paired_sw)_kernelILi(\d+)E(?:Lb([01])E)?",
                          m.group(1))
            kb = re.search(r"kbench_sw_kernelILi(\d+)ELi(\d+)E", m.group(1))
            if kb is not None:
                name = (f"kbench_sw {list(VARIANTS)[int(kb.group(1))]} "
                        f"R={kb.group(2)}")
            elif k is not None:
                kind = "multi_sw" if k.group(3) == "0" else k.group(1)
                name = f"{kind} R={k.group(2)}"
            else:
                name = m.group(1)
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def phase_build() -> None:
    from paragraph_tpu_torch.ops import _build
    from paragraph_tpu_torch.ops.multi_sw import WARP_LANES_PER_CTA
    from paragraph_tpu_torch.tools import kbench2

    t0 = time.perf_counter()
    _build.load()
    nvcc = ("already built" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.2f}s")
    say(f"[build] {_build.library_path().relative_to(ROOT)}: {nvcc}, "
        f"loaded in {time.perf_counter() - t0:.2f}s")
    report = ptxas_report(_build.build_log)
    k4 = {}
    for name, regs, spill in report:
        if name.startswith("kbench_sw "):
            k4[name] = (regs, spill)
        else:
            say(f"[build] {name}: {regs} registers, {spill} bytes spilled")
    # K4: registers at the bench's R (M=160) and the largest, and the
    # most any of its 15 instantiations spilled
    for v in kbench2.VARIANTS:
        regs = {r: k4.get(f"kbench_sw {v} R={r}", ("?", 0))[0]
                for r in (5, 26)}
        spill = max((sp for n, (_, sp) in k4.items()
                     if n.split()[1] == v), default=0)
        say(f"[build] kbench_sw {v}: {regs[5]} registers at R=5, "
            f"{regs[26]} at R=26, {spill} bytes spilled at most")
    spilled = [r for r in report if r[2]]
    if _build.build_log and (spilled or not report):
        raise AssertionError(f"ptxas spilled or reported nothing: {spilled}")
    # resident lanes (warps) per SM of the warp-per-lane kernels, at the
    # main path's M and the long-read cases' largest
    for kernel in ("graph_sw", "paired_sw", "multi_sw"):
        warps = {m: _build.blocks_per_sm(kernel, m, WARP_LANES_PER_CTA)
                 * WARP_LANES_PER_CTA for m in (160, LONG_M)}
        say(f"[build] {kernel}: resident warps (lanes) per SM "
            + ", ".join(f"{w} at M={m}" for m, w in warps.items()))
    say("[build] kbench_sw: resident warps (lanes) per SM at M=160: "
        + ", ".join(f"{v} " + str(WARP_LANES_PER_CTA * _build.blocks_per_sm(
            "kbench_sw", 160, WARP_LANES_PER_CTA, variant=i))
            for i, v in enumerate(kbench2.VARIANTS)))


# ---------------------------------------------------------------- phase 3


def _random_graph(rng, max_nodes=6, max_len=40, n_frac=0.0):
    n = rng.randint(2, max_nodes)
    alphabet = "ACGT"
    seqs = ["".join(("N" if rng.random() < n_frac else rng.choice(alphabet))
                    for _ in range(rng.randint(1, max_len)))
            for _ in range(n)]
    edges = []
    for t in range(1, n):
        preds = rng.sample(range(t), rng.randint(1, min(t, 3)))
        for f in sorted(preds):
            edges.append((f, t))
    return seqs, edges


def _read_from_graph(rng, seqs, edges, read_len=30, mutate=0.05,
                     indel=0.02):
    succ = {}
    for f, t in edges:
        succ.setdefault(f, []).append(t)
    node = 0
    out = seqs[0]
    while node in succ and len(out) < read_len * 3:
        node = rng.choice(succ[node])
        out += seqs[node]
    start = 0 if len(out) <= read_len else rng.randint(
        0, len(out) - read_len)
    read = list(out[start:start + read_len])
    i = 0
    while i < len(read):
        r = rng.random()
        if r < mutate:
            read[i] = rng.choice("ACGTN")
        elif r < mutate + indel:
            if rng.random() < 0.5:
                read.insert(i, rng.choice("ACGT"))
                i += 1
            else:
                del read[i]
                continue
        i += 1
    return "".join(read)


def _make_graph(seqs, edges):
    from paragraph_tpu_torch.graph.model import SequenceGraph

    g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    return g


def kernel_cases(seed: int):
    """(name, graphs, reads per pair) cases for kernel-vs-plain checks."""
    rng = random.Random(seed)

    def pairs(n_pairs, max_nodes, max_len, n_reads, lens, n_frac=0.0,
              empty_every=0):
        graphs, rpp = [], []
        for k in range(n_pairs):
            seqs, edges = _random_graph(rng, max_nodes, max_len, n_frac)
            graphs.append(_make_graph(seqs, edges))
            if empty_every and k % empty_every == 0:
                rpp.append([])
                continue
            reads = [_read_from_graph(rng, seqs, edges,
                                      read_len=rng.randint(*lens))
                     for _ in range(rng.randint(*n_reads))]
            rpp.append([r for r in reads if r])
        return graphs, rpp

    return [
        ("random", *pairs(6, 6, 40, (1, 12), (6, 60))),
        ("n_bases", *pairs(5, 6, 30, (1, 8), (6, 40), n_frac=0.1)),
        ("mixed_6_150", *pairs(8, 8, 120, (1, 40), (6, 150))),
        ("longer_than_graph", *pairs(4, 3, 8, (1, 6), (100, 150))),
        ("empty_pairs", *pairs(6, 5, 30, (1, 5), (6, 50), empty_every=2)),
        ("all_empty", *pairs(3, 4, 20, (0, 0), (6, 6))),
        ("pad_tiles", *pairs(3, 5, 40, (40, 70), (30, 150))),
        ("many_pairs", *pairs(48, 10, 200, (20, 120), (100, 150))),
    ]


def long_read_case(seed: int):
    """(graphs, reads per pair) with reads of LONG_READS bases: two graphs
    of long nodes, reads drawn from them, and one read of the first LONG_M
    bases of a graph's node sequences."""
    rng = random.Random(seed)
    graphs, rpp = [], []
    for _ in range(2):
        seqs, edges = _random_graph(rng, 6, 300)
        seqs = [s + "".join(rng.choice("ACGT") for _ in range(300))
                for s in seqs]
        graphs.append(_make_graph(seqs, edges))
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(*LONG_READS))
                 for _ in range(rng.randint(20, 40))]
        rpp.append([r for r in reads if r] + ["".join(seqs)[:LONG_M]])
    return graphs, rpp


def _case_tables(graphs, rpp, device):
    """FillTables of every chunk of a PairedGraphSW over the case."""
    from paragraph_tpu_torch.ops.multi_sw import (
        TILE_LANES, PairedGraphSW, build_pair_tables, dispatch_tables,
        graph_tensors)

    sw = PairedGraphSW(graphs, device=device)
    out = []
    for a, idxs in zip(sw.chunk_arrays, sw.chunk_pairs):
        t = build_pair_tables(a, [rpp[p] for p in idxs], TILE_LANES)
        out.append((dispatch_tables(t, *graph_tensors(a, sw.device),
                                    sw.device), t))
    return out


def _compare(kernel, plain, tables, label, **scoring):
    """Max abs error between a kernel and its plain fill on the same
    tensors; raises unless the [4, B] outputs are identical."""
    import torch

    got = kernel(tables, **scoring)
    torch.cuda.synchronize()
    want = plain(tables, **scoring)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).any(0).nonzero().flatten()[:8].tolist()
        raise AssertionError(
            f"{label}: kernel != plain at lanes {bad}: "
            f"kernel {got[:, bad].tolist()} plain {want[:, bad].tolist()}")
    return int((got.long() - want.long()).abs().max())


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    return float(out.split()[0]) * 1e6


def needed_cells(tables) -> int:
    """DP cells these inputs need: per lane, its tile's (or graph's)
    columns times its read's rows, min(len, M). The rows from len to the
    striped length hold pad codes: no output reads their cells."""
    M = tables.read_codes_t.shape[0] if hasattr(tables, "read_codes_t") \
        else tables.base_codes_t.shape[0]
    if hasattr(tables, "col_idx"):  # paired: rows of each lane's base read
        rows = tables.base_lens[0, tables.col_idx.long()]
    else:
        rows = tables.lens[0]
    rows = rows.clamp(max=M).long()
    if hasattr(tables, "tile_col_len"):
        lanes_per_tile = rows.shape[0] // tables.tile_col_len.shape[0]
        cols = tables.tile_col_len.long().repeat_interleave(lanes_per_tile)
        return int((cols * rows).sum())
    return int(rows.sum()) * tables.ref_codes.shape[0]


def fill_bound(tables, clock_hz: float):
    """(ms, "operations" or "bytes"): the least time the card could take
    for a fill on `tables`, the larger of its int32 operations (the cells
    these inputs need x OPS_PER_CELL over the SMs' INT32 lanes at the
    maximum clock) and its bytes (every input tensor read once, the
    [4, B] int32 output written once, at the memory rate)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_ms = (needed_cells(tables) * OPS_PER_CELL
              / (sms * INT32_LANES_PER_SM * clock_hz) * 1e3)
    tensors = [x for x in vars(tables).values()
               if isinstance(x, torch.Tensor)]
    lanes = tables.read_codes_t.shape[1] if hasattr(tables, "read_codes_t") \
        else tables.col_idx.shape[0]
    n_bytes = sum(x.numel() * x.element_size() for x in tensors) \
        + 4 * 4 * lanes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def phase_kernel_cases(card: str):
    import dataclasses

    import torch

    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  paired_fill_reference)

    max_err = 0
    for name, graphs, rpp in kernel_cases(seed=20261016):
        for ci, (tables, t) in enumerate(
                _case_tables(graphs, rpp, "cuda")):
            for idx_dtype in (torch.int16, torch.int32):
                tt = dataclasses.replace(
                    tables, col_idx=tables.col_idx.to(idx_dtype))
                max_err = max(max_err, _compare(
                    paired_fill, paired_fill_reference, tt,
                    f"{name}[{ci}] {idx_dtype}"))
            lanes = tables.col_idx.shape[0]
            say(f"[kernel] case {name} chunk {ci}: {lanes} lanes, "
                f"M={t['m']}, col_idx {t['col_idx'].dtype}: kernel == "
                f"plain (int16 and int32 col_idx)")
    for ci, (tables, t) in enumerate(_case_tables(*long_read_case(7),
                                                  "cuda")):
        if t["m"] < 512:
            raise AssertionError(f"long-read case has M={t['m']} < 512")
        max_err = max(max_err, _compare(paired_fill, paired_fill_reference,
                                        tables, f"long reads[{ci}]"))
        say(f"[kernel] case long reads chunk {ci}: "
            f"{tables.col_idx.shape[0]} lanes, M={t['m']}: kernel == plain")
    return max_err


def _first_round_tables(wl: str):
    """FillTables of the first dispatch of the main path's first round,
    built as the pipelined orchestrator builds it."""
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.graph.model import SequenceGraph
    from paragraph_tpu_torch.ops.multi_sw import (
        TILE_LANES, PairedGraphSW, build_pair_tables, dispatch_tables,
        graph_tensors)
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        load_graph_description)
    from paragraph_tpu_torch.pipeline.parallel_grmpy import (
        _extract_event, _root_desc)

    opts = _options(wl, os.path.join(wl, "ignored_round0"))
    descs = load_graph_description(opts)[:32]
    manifest = load_manifest(opts.manifest)
    specs = [(s.sample_name, s.filename, s.index_filename)
             for s in manifest]
    graphs = [SequenceGraph.from_json(_root_desc(d), opts.reference)
              for d in descs]
    batches = [_extract_event(gi, d, opts.reference, specs, 10000)[
        manifest[0].sample_name] for gi, d in enumerate(descs)]
    sw = PairedGraphSW(graphs, device="cuda")
    a = sw.chunk_arrays[0]
    t = build_pair_tables(a, [batches[p] for p in sw.chunk_pairs[0]],
                          TILE_LANES)
    return dispatch_tables(t, *graph_tensors(a, sw.device), sw.device), t


def phase_full_dispatch(card: str, wl: str, clock_hz: float):
    import torch

    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  paired_fill_reference)

    tables, t = _first_round_tables(wl)
    B = tables.col_idx.shape[0]
    err = _compare(paired_fill, paired_fill_reference, tables,
                   "full-size dispatch")
    # plain: one timed run (it ran once above)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paired_fill_reference(tables)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # kernel: mean over 5 launches between CUDA events, after warm-up
    paired_fill(tables)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        paired_fill(tables)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    cells = int(t["tile_col_len"].astype("int64").sum()) \
        * (B // len(t["tile_col_len"])) * t["m"]
    bound_ms, bound_by = fill_bound(tables, clock_hz)
    say(f"[kernel] full-size dispatch: T={len(t['tile_col_len'])} tiles "
        f"B={B} lanes M={t['m']} N={tables.pred_tables.shape[1]} "
        f"P={tables.pred_tables.shape[2]} max_clen="
        f"{int(t['tile_col_len'].max())} cells={cells}: kernel == plain; "
        f"kernel {kernel_ms:.3f} ms ({cells / kernel_ms / 1e6:.2f} "
        f"Gcells/s), bound {bound_ms:.3f} ms ({bound_by}, "
        f"{100 * bound_ms / kernel_ms:.1f}% of it), plain {plain_ms:.1f} ms "
        f"[{card}]")
    return err, kernel_ms, plain_ms, tables


# ---------------------------------------------------------------- phase 4


def _options(wl: str, out: str, vcf: str = "candidates.vcf"):
    from paragraph_tpu_torch.pipeline.multigrmpy import MultigrmpyOptions

    return MultigrmpyOptions(
        input=os.path.join(wl, vcf),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=out, split_type="superloci")


def ensure_workload(wl: str):
    """The planted events of the workload in `wl`, generated first if
    needed. The generator is a test tool of the repo that imports the
    JAX package's BGZF reader, so it runs in a subprocess of its own and
    this process only reads the truth.json it writes."""
    truth = os.path.join(wl, "truth.json")
    if os.path.isfile(truth):
        with open(truth) as f:
            events = json.load(f)
        if len(events) == N_EVENTS:
            say(f"[workload] reusing {wl}")
            return events
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "tools",
                                      "make_workload.py"), wl,
         "--events", str(N_EVENTS), "--depth", str(DEPTH), "--seed",
         str(SEED)], check=True, cwd=ROOT, env=env, timeout=600,
        stdout=subprocess.DEVNULL)
    with open(truth) as f:
        events = json.load(f)
    say(f"[workload] generated {N_EVENTS} events at {DEPTH}x in "
        f"{time.perf_counter() - t0:.1f}s")
    return events


def phase_main_path(card: str, wl: str, events):
    import torch

    from paragraph_tpu_torch.align.native import native_available
    from paragraph_tpu_torch.ops.multi_sw import paired_fill
    from paragraph_tpu_torch.pipeline.multigrmpy import run

    sys.path.insert(0, ROOT)
    from bench_e2e import check_truth

    native = native_available()
    say(f"[main] native traceback library loaded: {native}")
    if not native:
        raise RuntimeError("native traceback library did not load "
                           "(make -C native)")
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paired_fill.launches = 0
    t0 = time.perf_counter()
    out = run(_options(wl, os.path.join(wl, "out_cuda")), device="cuda",
              kernel_stats=stats)
    elapsed = time.perf_counter() - t0
    launches = paired_fill.launches
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0 or stats.get("dispatches", 0) <= 0:
        raise AssertionError(f"main path launched no kernel "
                             f"(launches={launches}, stats={stats})")
    n_ok, misses = check_truth(out["genotypes_vcf"], out["genotypes_json"],
                               events)
    unexpected = [m for m in misses if m["reason"] == "unexpected"]
    say(f"[main] {len(events)} events in {elapsed:.2f}s = "
        f"{len(events) / elapsed:.2f} SV/s; correct {n_ok}/{len(events)}, "
        f"misses {len(misses)} (unexpected {len(unexpected)}); "
        f"peak device memory {peak / 2**20:.1f} MiB [{card}]")
    wait = stats["device_wait_s"]
    say(f"[main] kernel launches={launches} dispatches={stats['dispatches']}"
        f" cells={stats['cells']} lanes={stats['lanes']} "
        f"device_wait={wait:.3f}s tables={stats['tables_s']:.3f}s "
        f"put={stats['put_s']:.3f}s call={stats['call_s']:.3f}s "
        f"cells_per_wait_s={stats['cells'] / wait if wait else 0:.4g} "
        f"[{card}]")
    if unexpected:
        raise AssertionError(f"unexpected misses: {unexpected[:5]}")
    return launches


# ---------------------------------------------------------------- phase 5


def _write_first_events_vcf(wl: str, events, n: int = EQ_EVENTS) -> str:
    """candidates.vcf cut to the records of the first n events."""
    last = events[n - 1]["pos"]
    out = os.path.join(wl, f"first{n}.vcf")
    with open(os.path.join(wl, "candidates.vcf")) as src, \
            open(out, "w") as dst:
        for line in src:
            if line.startswith("#") or int(line.split("\t")[1]) <= last:
                dst.write(line)
    return os.path.basename(out)


def _records(vcf_gz: str):
    with gzip.open(vcf_gz, "rt") as f:
        return [line for line in f if not line.startswith("#")]


def phase_cuda_equals_cpu(card: str, wl: str, events):
    from paragraph_tpu_torch.pipeline.multigrmpy import run

    vcf = _write_first_events_vcf(wl, events)
    outs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outs[device] = run(_options(wl, os.path.join(wl, f"eq_{device}"),
                                    vcf), device=device)
        say(f"[equal] {EQ_EVENTS} events on {device}: "
            f"{time.perf_counter() - t0:.2f}s [{card}]")
    with gzip.open(outs["cuda"]["genotypes_json"], "rb") as f:
        js_cuda = f.read()
    with gzip.open(outs["cpu"]["genotypes_json"], "rb") as f:
        js_cpu = f.read()
    if js_cuda != js_cpu:
        raise AssertionError("genotypes.json differs between cuda and cpu")
    rec_cuda = _records(outs["cuda"]["genotypes_vcf"])
    rec_cpu = _records(outs["cpu"]["genotypes_vcf"])
    if rec_cuda != rec_cpu or not rec_cuda:
        raise AssertionError("VCF records differ between cuda and cpu")
    say(f"[equal] cuda == cpu: genotypes.json {len(js_cuda)} bytes, "
        f"{len(rec_cuda)} VCF records identical")


# ---------------------------------------------------------------- phase 6


def _strip_engine(obj):
    if isinstance(obj, dict):
        return {k: _strip_engine(v) for k, v in obj.items() if k != "engine"}
    if isinstance(obj, list):
        return [_strip_engine(v) for v in obj]
    return obj


def _first_events_graphs(wl: str, events, n: int):
    """(options, graph descriptions) of the first n events."""
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        load_graph_description)

    opts = _options(wl, os.path.join(wl, f"per_event{n}"),
                    _write_first_events_vcf(wl, events, n))
    return opts, load_graph_description(opts)


def _graph_tables(graph, reads):
    from paragraph_tpu_torch.ops.batched_sw import GraphArrays, encode_reads
    from paragraph_tpu_torch.ops.pallas_sw import graph_tables_from_numpy

    max_len = max(len(r) for r in reads)
    codes, lens, vlens = encode_reads(reads, -(max_len // -32) * 32)
    return graph_tables_from_numpy(GraphArrays.build(graph), codes.T, lens,
                                   vlens, "cuda")


def _time_fill(kernel, plain, tables, reps):
    """(kernel ms: mean over `reps` launches between CUDA events after a
    warm-up; plain ms: one run)."""
    import torch

    kernel(tables)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernel(tables)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    plain(tables)
    torch.cuda.synchronize()
    return kernel_ms, (time.perf_counter() - t0) * 1e3


def phase_graph_kernel(card: str, opts, descs, clock_hz: float):
    from paragraph_tpu_torch.align.graph_aligner import reverse_complement
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.graph.model import SequenceGraph
    from paragraph_tpu_torch.ops.batched_sw import GraphArrays
    from paragraph_tpu_torch.ops.pallas_sw import (graph_fill,
                                                   graph_fill_reference)
    from paragraph_tpu_torch.pipeline.parallel_grmpy import (
        _extract_event, _root_desc)

    def compare(tables, label, **scoring):
        return _compare(graph_fill, graph_fill_reference, tables, label,
                        **scoring)

    max_err = 0
    for name, graphs, rpp in kernel_cases(seed=20261016):
        lanes = []
        for g, reads in [(g, r) for g, r in zip(graphs, rpp) if r][:3]:
            max_err = max(max_err, compare(_graph_tables(g, reads),
                                           f"{name} ({len(reads)})"))
            lanes.append(len(reads))
        say(f"[graph] case {name}: kernel == plain at {lanes} lanes")
    name, graphs, rpp = kernel_cases(seed=20261016)[0]
    max_err = max(max_err, compare(_graph_tables(graphs[0], rpp[0][:1]),
                                   "single read"))
    small = _make_graph(["ACGTTGCA", "GGATCC", "TTAGCA"],
                        [(0, 1), (0, 2), (1, 2)])
    max_err = max(max_err, compare(
        _graph_tables(small, ["ACGTTGCAGGATCC", "GGATCCTTAG", "CCCC"]),
        "match=100000", match=100000))
    say("[graph] single read and match=100000 (scores past the packed "
        "word): kernel == plain")
    for g, reads in zip(*long_read_case(7)):
        tables = _graph_tables(g, reads)
        M, B = tables.read_codes_t.shape
        if M < 512:
            raise AssertionError(f"long-read case has M={M} < 512")
        max_err = max(max_err, compare(tables, f"long reads ({B})"))
        say(f"[graph] case long reads: kernel == plain at {B} lanes, M={M}")

    # full size: the largest graph of the per-event run, its reads
    # repeated to FULL_READS, forward batch (fwd + revcomp)
    graphs = [SequenceGraph.from_json(_root_desc(d), opts.reference)
              for d in descs]
    cols = [len(GraphArrays.build(g).ref_codes) for g in graphs]
    gi = max(range(len(graphs)), key=cols.__getitem__)
    manifest = load_manifest(opts.manifest)
    specs = [(s.sample_name, s.filename, s.index_filename)
             for s in manifest]
    blob, lens = _extract_event(gi, descs[gi], opts.reference, specs,
                                10000)[manifest[0].sample_name]
    ends = [0, *lens.cumsum().tolist()]
    text = blob.decode()
    own = [text[a:b] for a, b in zip(ends, ends[1:])]
    full = (own * (FULL_READS // len(own) + 1))[:FULL_READS]
    times, full_tables = {}, None
    for label, fwd in (("full", full), ("event", own)):
        reads = fwd + [reverse_complement(r) for r in fwd]
        tables = _graph_tables(graphs[gi], reads)
        max_err = max(max_err, compare(tables, f"{label} dispatch"))
        reps = 5 if label == "full" else 20
        kernel_ms, plain_ms = _time_fill(graph_fill, graph_fill_reference,
                                         tables, reps)
        M, B = tables.read_codes_t.shape
        N, P = tables.pred_table.shape
        times[label] = (kernel_ms, plain_ms)
        if label == "full":
            full_tables = tables
        bound_ms, bound_by = fill_bound(tables, clock_hz)
        say(f"[graph] {label} dispatch, event {gi}: L={cols[gi]} N={N} "
            f"P={P} M={M} B={B} lanes: kernel == plain; kernel "
            f"{kernel_ms:.3f} ms ({cols[gi] * B * M / kernel_ms / 1e6:.2f} "
            f"Gcells/s issued), bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / kernel_ms:.1f}% of it), plain "
            f"{plain_ms:.1f} ms [{card}]")
    return max_err, times["full"][0], times["full"][1], full_tables


# ---------------------------------------------------------------- phase 7


def phase_per_event(card: str, wl: str, events, opts, descs):
    import copy

    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.pipeline.vcfupdate import (
        read_grmpy, update_vcf_from_grmpy)
    from paragraph_tpu_torch.ops.multi_sw import paired_fill
    from paragraph_tpu_torch.ops.pallas_sw import graph_fill
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy
    from paragraph_tpu_torch.pipeline.parallel_grmpy import _extract_event

    sys.path.insert(0, ROOT)
    from bench_e2e import check_truth

    manifest = load_manifest(opts.manifest)
    specs = [(s.sample_name, s.filename, s.index_filename)
             for s in manifest]
    with_reads = sum(
        1 for gi, d in enumerate(descs)
        for _, lens in _extract_event(gi, d, opts.reference, specs,
                                      10000).values() if len(lens))
    stats = {}
    graph_fill.launches = 0
    paired_fill.launches = 0
    t0 = time.perf_counter()
    results = run_grmpy(copy.deepcopy(descs), opts.reference, manifest,
                        None, GrmpyParameters(threads=1), batch_events=False,
                        device="cuda", kernel_stats=stats)
    elapsed = time.perf_counter() - t0
    launches = graph_fill.launches
    paired = paired_fill.launches
    say(f"[per-event] {len(descs)} events, per event on cuda: "
        f"{elapsed:.2f}s = {len(descs) / elapsed:.2f} SV/s; graph_sw "
        f"launches={launches} (2 x {with_reads} (event, sample) pairs with "
        f"reads), paired_sw launches={paired} [{card}]")
    wait = stats.get("device_wait_s", 0.0)
    say(f"[per-event] stats: dispatches={stats.get('dispatches')} "
        f"cells={stats.get('cells')} lanes={stats.get('lanes')} "
        f"device_wait={wait:.3f}s tables={stats.get('tables_s', 0):.3f}s "
        f"put={stats.get('put_s', 0):.3f}s call={stats.get('call_s', 0):.3f}s"
        f" dispatch_host={stats.get('dispatch_host_s', 0):.3f}s [{card}]")
    if launches != 2 * with_reads or paired != 0 \
            or stats.get("dispatches") != launches:
        raise AssertionError(
            f"per-event path: graph_sw launches {launches}, want "
            f"{2 * with_reads}; paired_sw launches {paired}, want 0; "
            f"stats {stats}")

    out_json = os.path.join(opts.output, "genotypes.json.gz")
    with gzip.open(out_json, "wt", compresslevel=2) as f:
        f.write(json.dumps(results, sort_keys=True, separators=(",", ":")))
    out_vcf = os.path.join(opts.output, "genotypes.vcf.gz")
    vcf_input = os.path.join(opts.output, "variants.vcf.gz")
    if not os.path.isfile(vcf_input):
        vcf_input = opts.input
    update_vcf_from_grmpy(vcf_input, read_grmpy(results), out_vcf,
                          [s.sample_name for s in manifest])
    n_ok, misses = check_truth(out_vcf, out_json, events[:len(descs)])
    unexpected = [m for m in misses if m["reason"] == "unexpected"]
    say(f"[per-event] correct {n_ok}/{len(descs)}, misses {len(misses)} "
        f"(unexpected {len(unexpected)})")
    if unexpected:
        raise AssertionError(f"unexpected misses: {unexpected[:5]}")

    t0 = time.perf_counter()
    batch = run_grmpy(copy.deepcopy(descs), opts.reference, manifest, None,
                      GrmpyParameters(threads=1), batch_events=True,
                      device="cuda")
    batch_s = time.perf_counter() - t0
    if json.dumps(_strip_engine(results), sort_keys=True) != json.dumps(
            _strip_engine(batch), sort_keys=True):
        raise AssertionError("per-event genotypes differ from the batch "
                             "path's")
    say(f"[per-event] per-event (graph_sw) == batch path (paired_sw, "
        f"{batch_s:.2f}s) apart from the engine marker [{card}]")
    return launches


# ---------------------------------------------------------------- phase 8


def phase_paragraph_cli(card: str, wl: str, opts, descs):
    from paragraph_tpu_torch.cli.main import main as cli_main
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest

    bam = load_manifest(opts.manifest)[0].filename
    for i, d in enumerate(descs):
        graph_path = os.path.join(wl, f"cli_event{i}.json")
        with open(graph_path, "w") as f:
            json.dump(d, f)
        outs, secs = {}, {}
        for device in ("cuda", "cpu"):
            out = os.path.join(wl, f"cli_event{i}_{device}.json")
            t0 = time.perf_counter()
            rc = cli_main(["paragraph", "-b", bam, "-g", graph_path, "-r",
                           opts.reference, "-o", out, "--device", device])
            secs[device] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"paragraph --device {device}: rc {rc}")
            with open(out) as f:
                outs[device] = json.load(f)
        engines = {dev: o["alignment_statistics"].get("engine")
                   for dev, o in outs.items()}
        if engines != {"cuda": "cuda", "cpu": "torch"}:
            raise AssertionError(f"paragraph engines {engines}")
        if json.dumps(_strip_engine(outs["cuda"]), sort_keys=True) != \
                json.dumps(_strip_engine(outs["cpu"]), sort_keys=True):
            raise AssertionError(f"paragraph JSON of event {i} differs "
                                 "between cuda and cpu")
        say(f"[paragraph] event {i}: cuda ({secs['cuda']:.2f}s) == cpu "
            f"({secs['cpu']:.2f}s) apart from the engine marker [{card}]")


# ---------------------------------------------------------------- phase 9


def phase_multi_kernel(card: str):
    import numpy as np

    from paragraph_tpu_torch.ops.multi_sw import (
        MultiGraphSW, multi_fill, multi_fill_reference)

    # the CPU side of many_pairs would take minutes: K2 runs the others
    cases = [(name, graphs, rpe, MultiGraphSW.COL_BUDGET)
             for name, graphs, rpe in kernel_cases(seed=20261016)
             if name != "many_pairs"]
    name, graphs, rpe, _ = cases[2]
    cases.append((f"{name} chunked", graphs, rpe, 64))
    multi_fill.launches = 0
    got = [MultiGraphSW(graphs, device="cuda", col_budget=budget).score(rpe)
           for _, graphs, rpe, budget in cases]
    launches = multi_fill.launches
    if launches <= 0:
        raise AssertionError("MultiGraphSW on cuda launched no multi_sw")
    for (name, graphs, rpe, budget), g_out in zip(cases, got):
        sw = MultiGraphSW(graphs, device="cpu", col_budget=budget)
        for e, (g, w) in enumerate(zip(g_out, sw.score(rpe))):
            for x, y in zip(g, w):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(
                        f"MultiGraphSW {name} event {e}: cuda != cpu")
        say(f"[multi] case {name}: {len(sw.chunk_events)} launch(es), "
            f"cuda == cpu")
    # timing on the tables of the largest case's first chunk
    name, graphs, rpe, _ = max(cases, key=lambda c: sum(map(len, c[2])))
    sw = MultiGraphSW(graphs, device="cuda")
    tables, _ = sw.tables(0, [rpe[e] for e in sw.chunk_events[0]])
    err = _compare(multi_fill, multi_fill_reference, tables,
                   f"multi {name}")
    kernel_ms, plain_ms = _time_fill(multi_fill, multi_fill_reference,
                                     tables, 5)
    M, B = tables.read_codes_t.shape
    say(f"[multi] timed case {name}: T={tables.tile_event.shape[0]} B={B} "
        f"M={M}: kernel == plain; kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms [{card}]")
    return err, launches, kernel_ms, plain_ms, tables


# --------------------------------------------------------------- phase 10


def _kbench_cases():
    """(name, K2 tables on cuda) for the ablation checks: phase 3's seeded
    cases (without many_pairs, whose plain fills would take minutes) as
    MultiGraphSW lays them out, and one case of reads with many indels."""
    from paragraph_tpu_torch.ops.multi_sw import MultiGraphSW

    cases = [c for c in kernel_cases(seed=20261016) if c[0] != "many_pairs"]
    rng = random.Random(4)
    graphs, rpe = [], []
    for _ in range(6):
        seqs, edges = _random_graph(rng, 6, 60)
        graphs.append(_make_graph(seqs, edges))
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(60, 150),
                                  mutate=0.03, indel=0.08)
                 for _ in range(rng.randint(20, 40))]
        rpe.append([r for r in reads if r])
    cases.append(("indels", graphs, rpe))
    out = []
    for name, graphs, rpe in cases:
        sw = MultiGraphSW(graphs, device="cuda")
        for ci, idxs in enumerate(sw.chunk_events):
            tables, _ = sw.tables(ci, [rpe[e] for e in idxs])
            out.append((f"{name}[{ci}]", tables))
    return out


def _kbench_check(tables, label, differs):
    """Every variant's kernel == its plain fill (kbench2.check_variants, so
    every exact variant == v0's plain fill), every exact variant == the
    multi kernel; notes which inexact variants differ from v0. Returns the
    max abs error."""
    import torch

    from paragraph_tpu_torch.ops.multi_sw import multi_fill
    from paragraph_tpu_torch.tools import kbench2

    outs = kbench2.check_variants(tables, kbench2.VARIANTS)
    k2 = multi_fill(tables)
    v0 = outs["v0"][0]
    err = 0
    for v, (got, want) in outs.items():
        if not torch.equal(got, want):
            bad = (got != want).any(0).nonzero().flatten()[:8].tolist()
            raise AssertionError(
                f"{label} {v}: kernel != plain at lanes {bad}: kernel "
                f"{got[:, bad].tolist()} plain {want[:, bad].tolist()}")
        err = max(err, int((got.long() - want.long()).abs().max()))
        if v in kbench2.EXACT:
            if not torch.equal(got, k2):
                raise AssertionError(f"{label} {v}: exact variant != "
                                     "multi_fill")
        else:
            differs[v] = differs.get(v, False) or not torch.equal(got, v0)
    return err


def phase_kbench(card: str, clock_hz: float):
    """K4: every ablation variant's kernel against its plain fill on the
    seeded cases, an indel case and the bench dispatch; then the kernel
    benchmark path (kbench2.time_variants) once per TPU kernel body, with
    the launch count set to 0 just before and read just after."""
    import torch

    from paragraph_tpu_torch.tools import kbench, kbench2

    t_start = time.perf_counter()
    max_err = 0
    differs = {}
    for label, tables in _kbench_cases():
        max_err = max(max_err, _kbench_check(tables, label, differs))
        M, B = tables.read_codes_t.shape
        say(f"[kbench] case {label}: B={B} M={M}: 12 variants, kernel == "
            f"plain, exact variants == v0 == multi_fill")
    bufs, cells = kbench2.bench_buffers(
        KBENCH_BUFFERS, KBENCH_READS, KBENCH_READ_LEN, 0,
        torch.device("cuda"))
    bench = bufs[0]
    max_err = max(max_err, _kbench_check(bench, "bench", differs))
    same = [v for v, d in differs.items() if not d]
    if same:
        raise AssertionError(f"inexact variants equal to v0 on every case: "
                             f"{same}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kbench2.kbench_fill_reference(bench, "v0")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    M, B = bench.read_codes_t.shape
    bound_ms, bound_by = fill_bound(bench, clock_hz)
    say(f"[kbench] bench dispatch: T={bench.tile_event.shape[0]} B={B} M={M}"
        f" cells={cells} (needed {needed_cells(bench)}): kernel == plain for"
        f" every variant; v0 plain {plain_ms:.1f} ms; bound "
        f"{bound_ms:.3f} ms ({bound_by}) [{card}]")

    ms, launches = {}, {}
    for body in KBENCH_BODIES:
        variants = [v for v in kbench2.VARIANTS
                    if kbench2.tpu_body(v) == body]
        kbench2.kbench_fill.launches = 0
        ms.update(kbench2.time_variants(bufs, variants))
        launches[body] = kbench2.kbench_fill.launches
        if launches[body] <= 0:
            raise AssertionError(f"kbench path launched no {body} variant")
    for v, t in ms.items():
        old = THREAD_PER_LANE_MS[v]
        say(f"[kbench] {v} ({kbench2.tpu_body(v)}): {t:.3f} ms per dispatch,"
            f" {cells / t / 1e6:.2f} Gcells/s issued, "
            f"{100 * bound_ms / t:.1f}% of the bound; thread per lane "
            f"{old:.3f} ms ({old / t:.2f}x) [{card}]")
    # the multi kernel (K2) on the same buffers: opt1_iprof is its body
    from paragraph_tpu_torch.ops.multi_sw import multi_fill

    multi_fill(bench)
    k2_ms = min(kbench.time_ms(lambda: [multi_fill(b) for b in bufs], 1,
                               bench.device) for _ in range(3)) / len(bufs)
    say(f"[kbench] multi_sw (K2) on the bench buffers: {k2_ms:.3f} ms per "
        f"dispatch, {cells / k2_ms / 1e6:.2f} Gcells/s issued, "
        f"{100 * bound_ms / k2_ms:.1f}% of the bound; thread per lane "
        f"{THREAD_PER_LANE_MS['multi_sw']:.3f} ms [{card}]")
    say(f"[kbench] opt1_iprof {ms['opt1_iprof']:.3f} ms against multi_sw "
        f"{k2_ms:.3f} ms on the same buffers: "
        f"{100 * (ms['opt1_iprof'] / k2_ms - 1):+.1f}% [{card}]")
    say(f"[kbench] phase 10 took {time.perf_counter() - t_start:.1f}s")
    return [{"name": f"kbench_sw:{body}", "route": "cuda",
             "source": KBENCH_SOURCE, "replaces": replaces,
             "launches": launches[body], "max_abs_err": max_err,
             "ms": ms[variant], "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}
            for body, (replaces, variant) in KBENCH_BODIES.items()]


def main() -> int:
    import logging

    # the port imports neither jax nor the JAX package: any such import
    # now fails the run
    sys.modules["jax"] = None
    sys.modules["paragraph_tpu"] = None
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")
    card = phase_device()
    phase_build()
    clock_hz = sm_clock_hz()
    say(f"[device] max SM clock {clock_hz / 1e6:.0f} MHz")
    err = phase_kernel_cases(card)
    events = ensure_workload(WORKLOAD)
    err_full, kernel_ms, plain_ms, k1_tables = phase_full_dispatch(
        card, WORKLOAD, clock_hz)
    launches = phase_main_path(card, WORKLOAD, events)
    phase_cuda_equals_cpu(card, WORKLOAD, events)
    opts, descs = _first_events_graphs(WORKLOAD, events, PER_EVENT_EVENTS)
    g_err, g_ms, g_plain_ms, k3_tables = phase_graph_kernel(card, opts,
                                                            descs, clock_hz)
    g_launches = phase_per_event(card, WORKLOAD, events, opts, descs)
    phase_paragraph_cli(card, WORKLOAD, opts, descs[:CLI_EVENTS])
    m_err, m_launches, m_ms, m_plain_ms, k2_tables = phase_multi_kernel(card)
    k4 = phase_kbench(card, clock_hz)

    import torch

    def bound(tables):
        ms, by = fill_bound(tables, clock_hz)
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    say(card)
    say(json.dumps({"kernels": [
        {"name": "paired_sw", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": launches,
         "max_abs_err": max(err, err_full), "ms": kernel_ms,
         "plain_ms": plain_ms, **bound(k1_tables)},
        {"name": "graph_sw", "route": "cuda", "source": GRAPH_SOURCE,
         "replaces": GRAPH_REPLACES, "launches": g_launches,
         "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain_ms,
         **bound(k3_tables)},
        {"name": "multi_sw", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": MULTI_REPLACES, "launches": m_launches,
         "max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain_ms,
         **bound(k2_tables)}, *k4]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
