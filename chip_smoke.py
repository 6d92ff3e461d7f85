#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (paragraph_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: torch / CUDA versions and the card's name and power limit
   (nvidia-smi); requires torch.cuda.is_available().
2. build: nvcc builds the kernels from paragraph_tpu_torch/ops/csrc/
   (first use; one nvcc per source, started together), with each
   kernel's registers and spills from ptxas (the row-band kernels of
   K1, K2 and K3 included; K4's per variant at R=5 and R=26; a spill in
   any instantiation fails the run), K1's, K2's and K3's resident warps
   per SM at M=160, M=800 and M=2048 (the band kernels), and each K4
   variant's at M=160 (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
3. read tables and K1 kernel vs plain: first the read-table kernel
   (ops/csrc/pair_tables.cu) on a realign-like dispatch (32 events x 106
   reads of 150 bases, every other read in lower case: T=128, B=16,384,
   M=160): its tensors equal to build_pair_tables + dispatch_tables and
   to pair_tables_reference on the card (tolerance 0), K1 on them equal
   to the plain fill, the kernel timed alone with its bytes' bound. Every
   K1 case below runs on tables staged and built by the table kernel as
   the scorer builds them, each held so to the host tables first. Then
   seeded random cases (N bases, read lengths 6-150,
   empty pairs, pad tiles, reads longer than the graph, int16 and int32
   col_idx), a long-read case (reads of 480-800 bases, M >= 512), a
   very-long-read case (reads of 833-2048 bases, M = 2048: the row-band
   kernel, on graphs of <= 256 columns, where the packed end-cell word
   holds 2048 rows) and one full-size dispatch (the first dispatch of
   phase 4's first round) go through the paired kernel and the plain
   PyTorch fill on the same CUDA tensors; the [4, B] outputs must be
   identical (tolerance 0: integer DP outputs). Times both at the
   full-size shape and on the very long reads, with the bound.
4. main path: the port's multigrmpy with device="cuda" on the repo's
   end-to-end workload (tests/tools/make_workload.py: 1000 mixed
   DEL/INS/DUP/INV/DEL+SNP events, 30x, 150 bp pairs, one sample, seed
   1; generated into smoke_workload/ by that script's command line in a
   subprocess, since it uses the JAX package's BGZF reader, and reused;
   this process reads its truth.json). Requires paired kernel
   launches on that run, one table kernel launch per dispatch (and
   `tables_on_card` equal to `dispatches`), zero unexpected misses
   against the planted
   truth (tools/bench_e2e.py::check_truth) and the native traceback library.
5. kernel path == plain path end to end: the first 16 events through
   the port on cuda and on cpu give identical genotypes JSON and VCF
   records.
6. K3 kernel vs plain: the single-graph kernel and its plain fill on
   the same CUDA tensors over phase 3's seeded graphs (N bases, read
   lengths 6-150, reads longer than the graph, a single read, lane
   counts that are not multiples of 32), a case whose scores overflow
   the JAX scorer's packed word (match=100000), phase 3's long-read
   graphs, very long reads (833-2048 bases) on those graphs (the
   row-band kernel, timed with its bound), and one full-size dispatch:
   the largest-graph event of the first 200, its extracted reads
   repeated to 10,000, as the forward batch of 20,000 orientations.
   Outputs identical; times both, with the bound, at that size and at
   the event's own read count.
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
11. population: the port's multigrmpy on cuda with gt_engine="auto" over
   the population bench's default workload (make_workload: 150 events, 8
   samples, 30x, seed 17; generated into smoke_workload_pop/ in a
   subprocess started before phase 2, waited for before phase 3's full
   dispatch), so the float32 device genotyping engine runs in the
   pipelined path's device_genotype stage. Requires paired kernel
   launches, device-engine jobs and that stage, and confident calls
   (GQ >= 10) equal to a gt_engine="host" run's on the same workload;
   reports SV x sample/s, the stage seconds and the confident-call
   accuracy against the planted genotypes
   (tools/bench_population.py::score_population).
12. multiparagraph: the port's multiparagraph tool on cuda over every DEL
   and INS event of phase 4's workload (400 events as the reference
   tool's event list: chrom, start, end, and ins for insertions), one
   template graph per event, its reads scored through the single-graph
   kernel. Requires K3 launches, every event back with its
   alignment_statistics, and the first 3 events on cpu giving the same
   JSON apart from the engine marker; reports events/s.
13. sharding, on a mesh of 4 shards of the one card ([cuda:0] * 4; the
   card host has one card, so no speed over several cards is measured):
   (a) every pair of phase 4's workload through ShardedPairedSW and
   PairedGraphSW: identical 5-tuples (tolerance 0), one K1 launch per
   slot (rounds x 4, less the empty shards of a short last round), both
   wall times in turns; (b) run_grmpy on the first 64 events over the
   mesh and over the default mesh: equal genotypes, zero unexpected
   misses; (c) two processes (gloo, a file:// rendezvous, both on
   cuda:0, tests/test_torch_multihost.py as the worker) run
   run_grmpy_multihost over all 1000 events: process 0's merged JSON ==
   phase 4's genotypes, apart from the engine marker; (d)
   graft_entry.dryrun_multichip(4) over the mesh on phase 11's workload
   (8 events x 8 samples) and entry("cuda")'s K3 fill == its plain fill;
   (e) a 16-event multigrmpy under PARAGRAPH_TPU_PROFILE, whose
   torch.profiler trace must name the paired kernel, then
   paragraph_tpu_torch/tools/prof_host.py by path on 64 events of phase
   4's workload (its JSON line of host ms per event).
14. bench harnesses: python -m paragraph_tpu_torch.tools.bench in a
   subprocess on the card (TMPDIR set to smoke_workload/bench_tmp/, so
   its workloads sit in the checkout: the end-to-end bench's 1000
   events of seed 11, generated by make_workload.py's command line in a
   subprocess started beside phase 11's and waited for with it, and
   phase 11's population workload linked in at the population bench's
   path). Requires its
   last line to say path "cuda", the card's name as its platform,
   cells/s > 0, zero unexpected misses in the end-to-end detail and the
   population's confident calls and accuracy equal to phase 11's auto
   run; reports cells/s (with the scorer's host table, copy and device
   wait seconds per dispatch), SV/s and SV x sample/s beside phases 4
   and 11. Then K1 alone on the bench's dispatch (tools/kbench.py's
   tables) in this process: kernel == plain, both timed, with the bound,
   to price the gap between the kernel and the whole dispatch.

Each kernel's launches are counted on its own path, with the counts set
to 0 just before it and read just after: the paired kernel and the
table kernel on phase 4 (and the paired kernel on phase 11's run,
reported there), the single-graph kernel on
phase 7 (and on phase 12's cuda run, reported beside it), the multi
kernel on phase 9's cuda runs, the ablation kernel on phase 10's timing
of each TPU body's variants; phase 13 counts the paired kernel's
launches of each of its sharded runs (and, in (a), the table kernel's,
one a K1 launch); phase 14 runs in a subprocess of
its own and counts nothing here. The process refuses to import jax and
the JAX package. The last three lines are the card's name and power limit,
then {"kernels": [...]} (paired_sw, graph_sw, multi_sw, pair_tables
and one kbench_sw entry per TPU kernel body of tools/kbench2.py, each
with its bound: for the fills the larger of the int32 operations (DPX
fused) the needed cells take on the card's INT32 lanes at the maximum
SM clock and the bytes of its tensors at the memory rate; for
pair_tables the bytes it reads and writes at the memory rate), then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import gzip
import json
import os
import random
import re
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKLOAD = os.path.join(ROOT, "smoke_workload")
POP_WORKLOAD = os.path.join(ROOT, "smoke_workload_pop")
#: the population bench's defaults (tools/bench_population.py): events,
#: samples, seed
POP_EVENTS = 150
POP_SAMPLES = 8
POP_SEED = 17
N_EVENTS = 1000
DEPTH = 30
SEED = 1
EQ_EVENTS = 16
PER_EVENT_EVENTS = 200
CLI_EVENTS = 3
FULL_READS = 10000
#: phase 13: shards of the one card, events of the sharded run_grmpy, of
#: the profiled multigrmpy and of the host profiler
MESH_SHARDS = 4
SHARDED_EVENTS = 64
PROFILE_EVENTS = 16
PROF_HOST_EVENTS = 64
#: phase 14: the bench harnesses' TMPDIR, the end-to-end bench's workload
#: (its defaults: 1000 events, seed 11) and the seconds the whole bench
#: may take
BENCH_TMP = os.path.join(WORKLOAD, "bench_tmp")
BENCH_E2E_EVENTS = 1000
BENCH_E2E_SEED = 11
BENCH_TIMEOUT_S = 420
KERNEL_SOURCE = "paragraph_tpu_torch/ops/csrc/paired_sw.cu"
KERNEL_REPLACES = "paragraph_tpu/ops/multi_sw.py:135"
GRAPH_SOURCE = "paragraph_tpu_torch/ops/csrc/graph_sw.cu"
GRAPH_REPLACES = "paragraph_tpu/ops/pallas_sw.py:91"
MULTI_REPLACES = "paragraph_tpu/ops/multi_sw.py:280"
KBENCH_SOURCE = "paragraph_tpu_torch/ops/csrc/kbench_sw.cu"
#: the read-table kernel, and the JAX package's host builder whose tables
#: it writes (no TPU kernel: the JAX package builds them on the host)
TABLES_SOURCE = "paragraph_tpu_torch/ops/csrc/pair_tables.cu"
TABLES_REPLACES = "paragraph_tpu/ops/multi_sw.py:442"
#: phase 3's realign-like dispatch for the table kernel: events, reads of
#: each, read length (the wgs30x.realign cell's 32-event rounds: about
#: 3,400 reads of 150 bases a dispatch, M=160)
TABLE_EVENTS = 32
TABLE_READS = 106
TABLE_READ_LEN = 150
#: the read tables of a paired dispatch, as FillTables holds them
TABLE_FIELDS = ("tile_col_start", "tile_col_len", "tile_event",
                "base_codes_t", "base_lens", "base_vlens", "col_idx", "flip",
                "comp")
#: the long-read cases of phases 3 and 6: reads of 480-800 bases, so M up
#: to LONG_M read rows (25 and 26 rows per thread in the warp-per-lane
#: kernels)
LONG_READS = (480, 800)
LONG_M = 800
#: the very-long-read cases of phases 3 and 6: reads of 833-2048 bases,
#: past one warp's 832 rows, so the kernels run in row bands
VERY_LONG_READS = (833, 2048)
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
    orientation expansion off, "band R=26" for their row-band kernels,
    kbench_sw <variant> R)."""
    from paragraph_tpu_torch.tools.kbench2 import VARIANTS

    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(graph_sw|paired_sw)_kernelILi(\d+)E(?:Lb([01])E)?",
                          m.group(1))
            kb = re.search(r"kbench_sw_kernelILi(\d+)ELi(\d+)E", m.group(1))
            band = re.search(r"(graph_sw|paired_sw)_band_kernel(?:ILb([01])E)?",
                             m.group(1))
            if band is not None:
                kind = "multi_sw" if band.group(2) == "0" else band.group(1)
                name = f"{kind} band R=26"
            elif kb is not None:
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
    # main path's M, the long-read cases' largest and the very long
    # reads' (the band kernels)
    for kernel in ("graph_sw", "paired_sw", "multi_sw"):
        warps = {m: _build.blocks_per_sm(kernel, m, WARP_LANES_PER_CTA)
                 * WARP_LANES_PER_CTA
                 for m in (160, LONG_M, VERY_LONG_READS[1])}
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


def _very_long_reads(rng, graph, n):
    """n reads of VERY_LONG_READS bases, the first of the longest: a
    stretch of a random path through `graph` between random flanks."""
    node, path = 0, graph.node_seq(0)
    while graph.successors(node):
        node = rng.choice(graph.successors(node))
        path += graph.node_seq(node)
    lo, hi = VERY_LONG_READS

    def flank(k):
        return "".join(rng.choice("ACGT") for _ in range(k))

    reads = []
    for i in range(n):
        total = hi if i == 0 else rng.randint(lo, hi)
        k = rng.randint(min(40, len(path)), min(len(path), total))
        a = rng.randint(0, len(path) - k)
        pre = rng.randint(0, total - k)
        reads.append(flank(pre) + path[a:a + k] + flank(total - pre - k))
    return reads


def very_long_read_case(seed: int, short_graphs: bool):
    """(graphs, reads per pair) with reads of VERY_LONG_READS bases: on
    long_read_case's graphs, or (short_graphs) on two graphs of at most
    250 columns, where the paired kernel's packed end-cell word holds
    2048 rows."""
    rng = random.Random(seed)
    if short_graphs:
        graphs = [_make_graph(*_random_graph(rng, 5, 50)) for _ in range(2)]
    else:
        graphs = long_read_case(seed)[0]
    return graphs, [_very_long_reads(rng, g, rng.randint(20, 40))
                    for g in graphs]


def _assert_tables_equal(got, want, label):
    """Raises unless two FillTables hold the same read tables: every
    tensor of TABLE_FIELDS equal in dtype, shape and value (tolerance 0),
    and l_ev."""
    import torch

    for field in TABLE_FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        if x.dtype != y.dtype or x.shape != y.shape \
                or not torch.equal(x, y):
            raise AssertionError(
                f"{label}: {field} differs ({x.dtype} {tuple(x.shape)} "
                f"against {y.dtype} {tuple(y.shape)})")
    if got.l_ev != want.l_ev:
        raise AssertionError(f"{label}: l_ev {got.l_ev} != {want.l_ev}")


def _staged_dispatch(a, pairs, device, label):
    """(FillTables of one dispatch as the scorer builds them on the card:
    staged by the host, built by the table kernel; the host's
    build_pair_tables dict). The kernel's tensors are held, tensor by
    tensor at tolerance 0, to build_pair_tables + dispatch_tables and to
    pair_tables_reference on the same card; layout, m and l_ev to the
    host's."""
    import torch

    from paragraph_tpu_torch.ops.multi_sw import (
        TILE_LANES, build_pair_tables, dispatch_tables, graph_tensors,
        pair_tables, pair_tables_reference, stage_pair_tables,
        staging_tensor)

    packed_cols, pred_tables = graph_tensors(a, device)
    s = stage_pair_tables(a, pairs, TILE_LANES)
    got = pair_tables(s, packed_cols, pred_tables)
    t = build_pair_tables(a, pairs, TILE_LANES)
    host = dispatch_tables(t, packed_cols, pred_tables, packed_cols.device)
    plain = pair_tables_reference(staging_tensor(s, pin=False), s,
                                  packed_cols, pred_tables)
    torch.cuda.synchronize()
    _assert_tables_equal(got, host, f"{label}: table kernel vs host")
    _assert_tables_equal(plain, host, f"{label}: plain tables vs host")
    if (s.layout, s.m, s.l_ev) != (t["layout"], t["m"], t["l_ev"]):
        raise AssertionError(f"{label}: staged layout, m or l_ev differ")
    return got, t


def _case_tables(graphs, rpp, device, label):
    """FillTables of every chunk of a PairedGraphSW over the case, built
    by the table kernel as the scorer builds them (_staged_dispatch)."""
    from paragraph_tpu_torch.ops.multi_sw import PairedGraphSW

    sw = PairedGraphSW(graphs, device=device)
    return [_staged_dispatch(a, [rpp[p] for p in idxs], sw.device,
                             f"{label}[{ci}]")
            for ci, (a, idxs) in enumerate(zip(sw.chunk_arrays,
                                               sw.chunk_pairs))]


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


def phase_kernel_cases(card: str, clock_hz: float):
    import dataclasses

    import torch

    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  paired_fill_reference)

    max_err = 0
    for name, graphs, rpp in kernel_cases(seed=20261016):
        for ci, (tables, t) in enumerate(
                _case_tables(graphs, rpp, "cuda", name)):
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
                                                  "cuda", "long reads")):
        if t["m"] < 512:
            raise AssertionError(f"long-read case has M={t['m']} < 512")
        max_err = max(max_err, _compare(paired_fill, paired_fill_reference,
                                        tables, f"long reads[{ci}]"))
        say(f"[kernel] case long reads chunk {ci}: "
            f"{tables.col_idx.shape[0]} lanes, M={t['m']}: kernel == plain")
    for ci, (tables, t) in enumerate(_case_tables(
            *very_long_read_case(7, short_graphs=True), "cuda",
            "very long reads")):
        if t["m"] != VERY_LONG_READS[1]:
            raise AssertionError(f"very-long-read case has M={t['m']}")
        max_err = max(max_err, _compare(paired_fill, paired_fill_reference,
                                        tables, f"very long reads[{ci}]"))
        kernel_ms, plain_ms = _time_fill(paired_fill, paired_fill_reference,
                                         tables, 5)
        bound_ms, bound_by = fill_bound(tables, clock_hz)
        say(f"[kernel] case very long reads chunk {ci} (row bands): "
            f"T={tables.tile_event.shape[0]} B={tables.col_idx.shape[0]} "
            f"lanes M={t['m']} l_ev={t['l_ev']}: kernel == plain; kernel "
            f"{kernel_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / kernel_ms:.1f}% of it), plain "
            f"{plain_ms:.1f} ms [{card}]")
    return max_err


def _realign_like_case(seed: int):
    """TABLE_EVENTS deletion graphs (flanks of 250 bases around an allele
    of 50-200) with TABLE_READS reads of TABLE_READ_LEN bases each, cut
    from the allele's path, every other read in lower case: one dispatch
    of the wgs30x.realign cell's shape."""
    from paragraph_tpu_torch.graph.model import SequenceGraph

    rng = random.Random(seed)

    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    graphs, rpp = [], []
    for _ in range(TABLE_EVENTS):
        left, alt, right = seq(250), seq(rng.randint(50, 200)), seq(250)
        g = SequenceGraph(["l", "a", "r"], [left, alt, right])
        g.add_edge(0, 1)
        g.add_edge(1, 2)
        g.add_edge(0, 2)
        graphs.append(g)
        path = left + alt + right
        reads = [path[x:x + TABLE_READ_LEN] for x in (
            rng.randrange(len(path) - TABLE_READ_LEN)
            for _ in range(TABLE_READS))]
        rpp.append([r.lower() if i % 2 else r for i, r in enumerate(reads)])
    return graphs, rpp


def phase_table_kernel(card: str):
    """The read-table kernel on a realign-like dispatch: its tensors ==
    the host tables and the plain tables (tolerance 0), K1 on them ==
    the plain fill, the kernel timed alone (CUDA events; L2 flushed
    before each of 50 launches, median, and 200 back to back, mean)
    against its bytes at the memory rate, the plain tables once. Returns
    the kernel's entry of the kernels line (launches filled in by phase
    4)."""
    import statistics

    import torch

    from paragraph_tpu_torch.ops import multi_sw as msw

    graphs, rpp = _realign_like_case(SEED)
    sw = msw.PairedGraphSW(graphs, device="cuda")
    if len(sw.chunk_arrays) != 1:
        raise AssertionError(f"realign-like case: {len(sw.chunk_arrays)} "
                             f"chunks, want 1")
    a, pairs = sw.chunk_arrays[0], [rpp[p] for p in sw.chunk_pairs[0]]
    tables, t = _staged_dispatch(a, pairs, sw.device,
                                 "realign-like dispatch")
    err = _compare(msw.paired_fill, msw.paired_fill_reference, tables,
                   "K1 on the table kernel's tables")
    s = msw.stage_pair_tables(a, pairs, msw.TILE_LANES)
    staging = msw.staging_tensor(s, pin=True)
    ws, v = msw._workspace(s, sw.device)
    ws[:staging.numel()].copy_(staging)
    for _ in range(10):
        msw._launch_tables(v, s, sw.device)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=sw.device)
    cold = []
    for _ in range(50):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        msw._launch_tables(v, s, sw.device)
        stop.record()
        torch.cuda.synchronize()
        cold.append(start.elapsed_time(stop))
    reps = 200
    start.record()
    for _ in range(reps):
        msw._launch_tables(v, s, sw.device)
    stop.record()
    torch.cuda.synchronize()
    warm_ms = start.elapsed_time(stop) / reps
    kernel_ms = statistics.median(cold)
    plain_staging = msw.staging_tensor(s, pin=False)
    msw.pair_tables_reference(plain_staging, s, *msw.graph_tensors(
        a, sw.device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msw.pair_tables_reference(plain_staging, s, *msw.graph_tensors(
        a, sw.device))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    B = s.T * s.TB
    # in: the staged ints and bytes; out: codes, vlens, col_idx, flip,
    # comp
    n_bytes = staging.numel() + s.m * s.Bb + 4 * s.Bb \
        + B * (tables.col_idx.element_size() + 2)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    say(f"[tables] realign-like dispatch: T={s.T} B={B} lanes Bb={s.Bb} "
        f"reads M={s.m}, {staging.numel()} staged bytes: table kernel == "
        f"host tables == plain tables (tolerance 0), K1 on them == plain; "
        f"kernel {kernel_ms:.4f} ms alone (L2 flushed, median of 50), "
        f"{warm_ms:.4f} ms back to back; bound {bound_ms:.6f} ms (bytes: "
        f"{n_bytes} in and out at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{100 * bound_ms / kernel_ms:.1f}% of it); plain {plain_ms:.2f} "
        f"ms [{card}]")
    return {"name": "pair_tables", "route": "cuda",
            "source": TABLES_SOURCE, "replaces": TABLES_REPLACES,
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def _first_round_tables(wl: str):
    """FillTables of the first dispatch of the main path's first round,
    staged from the reads as the pipelined orchestrator ships them and
    built by the table kernel (_staged_dispatch)."""
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.graph.model import SequenceGraph
    from paragraph_tpu_torch.ops.multi_sw import PairedGraphSW
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
    return _staged_dispatch(sw.chunk_arrays[0],
                            [batches[p] for p in sw.chunk_pairs[0]],
                            sw.device, "full-size dispatch")


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
    from paragraph_tpu_torch.tools import bench_e2e

    events = bench_e2e.workload_events(wl, N_EVENTS)
    if events is not None:
        say(f"[workload] reusing {wl}")
        return events
    t0 = time.perf_counter()
    bench_e2e.run_generator(bench_e2e.generator_argv(
        wl, N_EVENTS, SEED, "--depth", str(DEPTH)), timeout=600)
    events = bench_e2e.workload_events(wl, N_EVENTS)
    say(f"[workload] generated {N_EVENTS} events at {DEPTH}x in "
        f"{time.perf_counter() - t0:.1f}s")
    return events


def phase_main_path(card: str, wl: str, events):
    import torch

    from paragraph_tpu_torch.align.native import native_available
    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  pair_tables_kernel)
    from paragraph_tpu_torch.pipeline.multigrmpy import run
    from paragraph_tpu_torch.tools.bench_e2e import check_truth

    native = native_available()
    say(f"[main] native traceback library loaded: {native}")
    if not native:
        raise RuntimeError("native traceback library did not load "
                           "(make -C native)")
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paired_fill.launches = 0
    pair_tables_kernel.launches = 0
    t0 = time.perf_counter()
    out = run(_options(wl, os.path.join(wl, "out_cuda")), device="cuda",
              kernel_stats=stats)
    elapsed = time.perf_counter() - t0
    launches = paired_fill.launches
    table_launches = pair_tables_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0 or stats.get("dispatches", 0) <= 0:
        raise AssertionError(f"main path launched no kernel "
                             f"(launches={launches}, stats={stats})")
    if table_launches != stats["dispatches"] \
            or stats.get("tables_on_card") != stats["dispatches"]:
        raise AssertionError(
            f"main path: table kernel launches {table_launches}, "
            f"tables_on_card {stats.get('tables_on_card')}, want one a "
            f"dispatch ({stats['dispatches']})")
    n_ok, misses = check_truth(out["genotypes_vcf"], out["genotypes_json"],
                               events)
    unexpected = [m for m in misses if m["reason"] == "unexpected"]
    say(f"[main] {len(events)} events in {elapsed:.2f}s = "
        f"{len(events) / elapsed:.2f} SV/s; correct {n_ok}/{len(events)}, "
        f"misses {len(misses)} (unexpected {len(unexpected)}); "
        f"peak device memory {peak / 2**20:.1f} MiB [{card}]")
    k1_s = stats["k1_s"]
    say(f"[main] kernel launches={launches} table kernel launches="
        f"{table_launches} tables_on_card={stats['tables_on_card']} "
        f"dispatches={stats['dispatches']}"
        f" cells={stats['cells']} k1={k1_s:.3f}s "
        f"device_wait={stats['device_wait_s']:.3f}s "
        f"tables={stats['tables_s']:.3f}s "
        f"put={stats['put_s']:.3f}s call={stats['call_s']:.3f}s "
        f"slice={stats['slice_s']:.3f}s "
        f"cells_per_k1_s={stats['cells'] / k1_s if k1_s else 0:.4g} "
        f"[{card}]")
    if unexpected:
        raise AssertionError(f"unexpected misses: {unexpected[:5]}")
    return launches, table_launches, len(events) / elapsed


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
    for g, reads in zip(*very_long_read_case(7, short_graphs=False)):
        tables = _graph_tables(g, reads)
        M, B = tables.read_codes_t.shape
        if M != VERY_LONG_READS[1]:
            raise AssertionError(f"very-long-read case has M={M}")
        max_err = max(max_err, compare(tables, f"very long reads ({B})"))
        kernel_ms, plain_ms = _time_fill(graph_fill, graph_fill_reference,
                                         tables, 5)
        bound_ms, bound_by = fill_bound(tables, clock_hz)
        say(f"[graph] case very long reads (row bands): L="
            f"{tables.ref_codes.shape[0]} B={B} lanes M={M}: kernel == "
            f"plain; kernel {kernel_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {100 * bound_ms / kernel_ms:.1f}% of it), plain "
            f"{plain_ms:.1f} ms [{card}]")

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


def _check_against_truth(label: str, opts, manifest, results, events):
    """Write genotypes.json.gz and the VCF as multigrmpy does into
    opts.output and require zero unexpected misses against the planted
    truth of the first len(results) events."""
    from paragraph_tpu_torch.pipeline.vcfupdate import (
        read_grmpy, update_vcf_from_grmpy)
    from paragraph_tpu_torch.tools.bench_e2e import check_truth

    out_json = os.path.join(opts.output, "genotypes.json.gz")
    with gzip.open(out_json, "wt", compresslevel=2) as f:
        f.write(json.dumps(results, sort_keys=True, separators=(",", ":")))
    out_vcf = os.path.join(opts.output, "genotypes.vcf.gz")
    vcf_input = os.path.join(opts.output, "variants.vcf.gz")
    if not os.path.isfile(vcf_input):
        vcf_input = opts.input
    update_vcf_from_grmpy(vcf_input, read_grmpy(results), out_vcf,
                          [s.sample_name for s in manifest])
    n_ok, misses = check_truth(out_vcf, out_json, events[:len(results)])
    unexpected = [m for m in misses if m["reason"] == "unexpected"]
    say(f"[{label}] correct {n_ok}/{len(results)}, misses {len(misses)} "
        f"(unexpected {len(unexpected)})")
    if unexpected:
        raise AssertionError(f"unexpected misses: {unexpected[:5]}")


def phase_per_event(card: str, wl: str, events, opts, descs):
    import copy

    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.ops.multi_sw import paired_fill
    from paragraph_tpu_torch.ops.pallas_sw import graph_fill
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy
    from paragraph_tpu_torch.pipeline.parallel_grmpy import _extract_event

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
    say(f"[per-event] stats: dispatches={stats.get('dispatches')} "
        f"cells={stats.get('cells')} k3={stats.get('k1_s', 0):.3f}s "
        f"device_wait={stats.get('device_wait_s', 0):.3f}s "
        f"tables={stats.get('tables_s', 0):.3f}s "
        f"put={stats.get('put_s', 0):.3f}s call={stats.get('call_s', 0):.3f}s"
        f" slice={stats.get('slice_s', 0):.3f}s [{card}]")
    if launches != 2 * with_reads or paired != 0 \
            or stats.get("dispatches") != launches:
        raise AssertionError(
            f"per-event path: graph_sw launches {launches}, want "
            f"{2 * with_reads}; paired_sw launches {paired}, want 0; "
            f"stats {stats}")

    _check_against_truth("per-event", opts, manifest, results, events)

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


# --------------------------------------------------------------- phase 11


def _pop_events(wl: str):
    """The planted events of a complete population workload in `wl`, or
    None."""
    from paragraph_tpu_torch.tools.bench_population import workload_events

    return workload_events(wl, POP_EVENTS, POP_SAMPLES)


def start_pop_workload(wl: str):
    """Start generating phase 11's workload into `wl` in a subprocess, as
    bench_population does (make_workload uses the JAX package's BGZF
    reader); returns the process, or None when a complete one is there."""
    from paragraph_tpu_torch.tools import bench_e2e, bench_population

    if _pop_events(wl) is not None:
        return None
    return bench_e2e.start_generator(bench_population.generator_argv(
        wl, POP_EVENTS, POP_SAMPLES, POP_SEED))


def bench_e2e_workload() -> str:
    """The end-to-end bench's workload directory under BENCH_TMP."""
    from paragraph_tpu_torch.tools.bench_e2e import default_workload

    return default_workload(BENCH_E2E_EVENTS, BENCH_E2E_SEED, BENCH_TMP)


def start_bench_workload():
    """Start generating phase 14's end-to-end workload at the bench's
    path, as the bench itself would, in a subprocess; returns the
    process, or None when a complete one is there."""
    from paragraph_tpu_torch.tools import bench_e2e

    wl = bench_e2e_workload()
    if bench_e2e.workload_events(wl, BENCH_E2E_EVENTS) is not None:
        return None
    os.makedirs(BENCH_TMP, exist_ok=True)
    return bench_e2e.start_generator(bench_e2e.generator_argv(
        wl, BENCH_E2E_EVENTS, BENCH_E2E_SEED))


def finish_bench_workload(proc) -> None:
    """Wait for start_bench_workload's process."""
    if proc is None:
        say(f"[workload] reusing {bench_e2e_workload()}")
        return
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    if rc != 0:
        raise RuntimeError(f"bench workload generation: rc {rc}")
    say(f"[workload] bench workload ({BENCH_E2E_EVENTS} events, seed "
        f"{BENCH_E2E_SEED}) ready; waited {time.perf_counter() - t0:.1f}s "
        f"for it")


def finish_pop_workload(proc, wl: str):
    """Wait for start_pop_workload's process; the workload's events."""
    if proc is not None:
        t0 = time.perf_counter()
        rc = proc.wait(timeout=900)
        if rc != 0:
            raise RuntimeError(f"population workload generation: rc {rc}")
        say(f"[workload] population workload ({POP_EVENTS} events x "
            f"{POP_SAMPLES} samples) ready; waited "
            f"{time.perf_counter() - t0:.1f}s for it")
    events = _pop_events(wl)
    if events is None:
        raise RuntimeError(f"no complete population workload in {wl}")
    return events


def _confident_calls_match(host_json: str, device_json: str) -> int:
    """Raise unless every confident host call (sample genotypes with GQ >=
    10 and PASS, breakpoint genotypes with GQ >= 10) has the same GT in
    the device engine's run, with equal breakpoint counts; returns the
    number of calls checked."""
    with gzip.open(host_json, "rt") as f:
        host = json.load(f)
    with gzip.open(device_json, "rt") as f:
        device = json.load(f)
    if len(host) != len(device):
        raise AssertionError("host and device runs differ in events")
    n = 0
    for rec_h, rec_d in zip(host, device):
        for name, sh in rec_h["samples"].items():
            sd = rec_d["samples"][name]
            gt_h, gt_d = sh["gt"], sd["gt"]
            if gt_h.get("GQ", 0) >= 10 and "PASS" in gt_h.get("filters", []):
                if gt_d["GT"] != gt_h["GT"]:
                    raise AssertionError(f"{name}: host {gt_h} device {gt_d}")
                n += 1
            for bp, bp_h in sh.get("breakpoints", {}).items():
                bp_d = sd["breakpoints"][bp]
                if bp_d["counts"] != bp_h["counts"]:
                    raise AssertionError(f"{name} {bp}: counts differ")
                if bp_h["gt"].get("GQ", 0) >= 10:
                    if bp_d["gt"]["GT"] != bp_h["gt"]["GT"]:
                        raise AssertionError(
                            f"{name} {bp}: host {bp_h['gt']} device "
                            f"{bp_d['gt']}")
                    n += 1
    return n


def phase_population(card: str, wl: str, events):
    """multigrmpy over the population workload with gt_engine="auto" (the
    device engine) and "host"; returns the auto run's SV x sample/s,
    confident calls and correct confident calls."""
    from paragraph_tpu_torch.ops.multi_sw import paired_fill
    from paragraph_tpu_torch.pipeline.multigrmpy import run
    from paragraph_tpu_torch.tools.bench_population import score_population

    samples = sorted(events[0]["gts"])
    outs, stats, secs = {}, {}, {}
    launches = 0
    for engine in ("auto", "host"):
        opts = _options(wl, os.path.join(wl, f"out_{engine}"))
        opts.gt_engine = engine
        stats[engine] = {}
        paired_fill.launches = 0
        t0 = time.perf_counter()
        outs[engine] = run(opts, device="cuda", kernel_stats=stats[engine])
        secs[engine] = time.perf_counter() - t0
        if engine == "auto":
            launches = paired_fill.launches
        n_sv = len(events) * len(samples)
        stage = {k: round(v, 3)
                 for k, v in sorted(stats[engine].get("stage_s", {}).items())}
        say(f"[population] {len(events)} events x {len(samples)} samples, "
            f"gt_engine={engine}: {secs[engine]:.2f}s = "
            f"{n_sv / secs[engine]:.2f} SV x sample/s; device engine jobs "
            f"{stats[engine].get('gt_device_jobs', 0)} in "
            f"{stats[engine].get('gt_device_call_s', 0.0):.4f}s of model "
            f"calls; stage seconds {stage} [{card}]")
    auto = stats["auto"]
    if launches <= 0 or auto.get("gt_device_jobs", 0) <= 0 \
            or "device_genotype" not in auto.get("stage_s", {}):
        raise AssertionError(f"population run: paired launches {launches}, "
                             f"stats {auto}")
    if "gt_device_jobs" in stats["host"]:
        raise AssertionError("gt_engine=host ran the device engine")
    n_checked = _confident_calls_match(outs["host"]["genotypes_json"],
                                       outs["auto"]["genotypes_json"])
    if n_checked <= 0:
        raise AssertionError("no confident host call to compare")
    acc = {}
    for engine in ("auto", "host"):
        n_conf, n_ok = score_population(outs[engine]["genotypes_vcf"],
                                        events, samples)
        acc[engine] = (n_conf, n_ok)
        say(f"[population] gt_engine={engine}: confident calls {n_conf}, "
            f"correct {n_ok} ({n_ok / max(n_conf, 1):.4f})")
    say(f"[population] device engine == host engine on {n_checked} "
        f"confident calls; paired_sw launches={launches}, device_genotype "
        f"{auto['stage_s']['device_genotype']:.3f}s [{card}]")
    if acc["auto"][0] <= 0:
        raise AssertionError("no confident call in the population run")
    say(f"[population] the model's call on {auto['gt_device_jobs']} jobs: "
        f"{auto['gt_device_call_s']:.4f}s in the run (the process's first), "
        f"{_warm_model_call_s(auto['gt_device_jobs']) * 1e3:.3f} ms warm "
        f"[{card}]")
    return (len(events) * len(samples) / secs["auto"], *acc["auto"])


def _warm_model_call_s(n: int) -> float:
    """Seconds of one sharded_population_genotyping call on n seeded
    biallelic diploid jobs on the card, after one untimed call."""
    import numpy as np

    from paragraph_tpu_torch.genotyping.batched import model_from_parameters
    from paragraph_tpu_torch.genotyping.parameters import (
        GenotypingParameters)
    from paragraph_tpu_torch.parallel.mesh import (
        make_mesh, sharded_population_genotyping)

    rng = np.random.default_rng(0)
    model = model_from_parameters(GenotypingParameters(["REF", "ALT"], 2),
                                  "cuda")
    args = (rng.poisson(12, (n, 2)), np.full(n, 30.0), np.full(n, 150.0),
            np.full(n, 12.25), rng.random(n) < 0.5, model)
    mesh = make_mesh("cuda", 1)
    sharded_population_genotyping(mesh, *args)
    t0 = time.perf_counter()
    sharded_population_genotyping(mesh, *args)
    return time.perf_counter() - t0


# --------------------------------------------------------------- phase 12


def _multiparagraph_events(events, contig: str):
    """multiparagraph's event list for every DEL and INS of the workload,
    in the reference tool's convention: deleted bases start..end; an
    insertion after base `pos` has end = start - 1 and its sequence."""
    out = []
    for ev in events:
        if ev["kind"] == "DEL":
            out.append({"chrom": contig, "start": ev["pos"] + 1,
                        "end": ev["pos"] + ev["size"]})
        elif ev["kind"] == "INS":
            out.append({"chrom": contig, "start": ev["pos"] + 1,
                        "end": ev["pos"], "ins": ev["ins_seq"]})
    return out


def phase_multiparagraph(card: str, wl: str, events):
    """The port's multiparagraph tool on cuda over every DEL and INS event
    of the workload, then its first CLI_EVENTS events on cpu; returns the
    single-graph kernel's launches in the cuda run."""
    from paragraph_tpu_torch.cli.main import main as cli_main
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.ops.pallas_sw import graph_fill

    opts = _options(wl, os.path.join(wl, "multiparagraph"))
    bam = load_manifest(opts.manifest)[0].filename
    with open(opts.reference) as f:
        contig = f.readline()[1:].split()[0]
    event_list = _multiparagraph_events(events, contig)
    path = os.path.join(wl, "multiparagraph_events.json")
    with open(path, "w") as f:
        json.dump(event_list, f)
    outs, secs = {}, {}
    launches = 0
    for device, extra in (("cuda", []),
                          ("cpu", ["--max-events", str(CLI_EVENTS)])):
        out = os.path.join(wl, f"multiparagraph_{device}.json")
        graph_fill.launches = 0
        t0 = time.perf_counter()
        rc = cli_main(["multiparagraph", path, "-b", bam, "-r",
                       opts.reference, "-o", out, "--device", device]
                      + extra)
        secs[device] = time.perf_counter() - t0
        if device == "cuda":
            launches = graph_fill.launches
        if rc != 0:
            raise AssertionError(
                f"multiparagraph --device {device}: rc {rc}")
        with open(out) as f:
            outs[device] = json.load(f)
    n = len(event_list)
    got = outs["cuda"]
    if len(got) != n or any(
            e["graph"].get("alignment_statistics", {}).get("engine")
            != "cuda" for e in got):
        raise AssertionError(f"multiparagraph on cuda: {len(got)} of {n} "
                             "events came back with cuda alignment "
                             "statistics")
    if not 0 < launches <= 2 * n:
        raise AssertionError(f"multiparagraph on cuda: graph_sw launches "
                             f"{launches}, want 1..{2 * n}")
    n_ins = sum(1 for e in event_list if "ins" in e)
    say(f"[multiparagraph] {n} events ({n_ins} INS), on cuda: "
        f"{secs['cuda']:.2f}s = {n / secs['cuda']:.2f} events/s; "
        f"graph_sw launches={launches} [{card}]")
    if json.dumps(_strip_engine(got[:CLI_EVENTS]), sort_keys=True) != \
            json.dumps(_strip_engine(outs["cpu"]), sort_keys=True):
        raise AssertionError(f"multiparagraph JSON of the first "
                             f"{CLI_EVENTS} events differs between cuda "
                             "and cpu")
    say(f"[multiparagraph] first {CLI_EVENTS} events: cuda == cpu "
        f"({secs['cpu']:.2f}s) apart from the engine marker [{card}]")
    return launches


# --------------------------------------------------------------- phase 13


def _mesh():
    """Phase 13's mesh: MESH_SHARDS shards on the one card."""
    import torch

    return [torch.device("cuda", 0)] * MESH_SHARDS


def _all_pairs(wl: str):
    """(graphs, read batches as (blob, lens)) of every (event x sample)
    pair of the workload in `wl`, in phase 4's order."""
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.graph.model import SequenceGraph
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        load_graph_description)
    from paragraph_tpu_torch.pipeline.parallel_grmpy import (
        _WORKER_STATE, _extract_event, _root_desc)

    opts = _options(wl, os.path.join(wl, "sharded_pairs"))
    descs = load_graph_description(opts)
    manifest = load_manifest(opts.manifest)
    specs = [(s.sample_name, s.filename, s.index_filename)
             for s in manifest]
    graphs, batches = [], []
    for gi, d in enumerate(descs):
        graph = SequenceGraph.from_json(_root_desc(d), opts.reference)
        reads = _extract_event(gi, d, opts.reference, specs, 10000)
        for s in manifest:
            graphs.append(graph)
            batches.append(reads[s.sample_name])
    _WORKER_STATE.get("event_reads", {}).clear()
    return graphs, batches


def _sharded_scorer(card: str, wl: str):
    """(a): every pair of phase 4's workload through ShardedPairedSW on
    MESH_SHARDS shards of the card and through PairedGraphSW: identical
    5-tuples, one K1 launch per slot; wall times in turns."""
    import numpy as np
    import torch

    from paragraph_tpu_torch.ops.multi_sw import (
        PairedGraphSW, paired_fill, pair_tables_kernel)
    from paragraph_tpu_torch.parallel.distributed import ShardedPairedSW

    t0 = time.perf_counter()
    graphs, batches = _all_pairs(wl)
    say(f"[sharded] {len(batches)} pairs extracted in "
        f"{time.perf_counter() - t0:.1f}s")
    scorers = {"single": PairedGraphSW(graphs, device="cuda"),
               "sharded": ShardedPairedSW(graphs, _mesh())}
    sharded = scorers["sharded"]
    outs, secs, launches = {}, {k: [] for k in scorers}, {}
    for name in ("single", "sharded", "sharded", "single"):
        torch.cuda.synchronize()
        paired_fill.launches = 0
        pair_tables_kernel.launches = 0
        t0 = time.perf_counter()
        outs[name] = scorers[name].score_pairs(batches)
        secs[name].append(time.perf_counter() - t0)
        launches[name] = paired_fill.launches
        if pair_tables_kernel.launches != launches[name]:
            raise AssertionError(
                f"{name}: table kernel launches "
                f"{pair_tables_kernel.launches}, K1 {launches[name]}")
    for k, (got, want) in enumerate(zip(outs["sharded"], outs["single"])):
        for side in range(2):
            for x, y in zip(got[side], want[side]):
                if not np.array_equal(x, y):
                    raise AssertionError(f"sharded != single at pair {k}")
    n_rounds = len(sharded.rounds)
    fillers = MESH_SHARDS * n_rounds - len(sharded.slot_pairs)
    if launches["sharded"] != len(sharded.slot_pairs) \
            or launches["sharded"] != sum(len(r) for r in sharded.rounds) \
            or launches["single"] != len(scorers["single"].chunk_pairs):
        raise AssertionError(f"launches {launches}, slots "
                             f"{len(sharded.slot_pairs)}, rounds {n_rounds}")
    say(f"[sharded] (a) {len(batches)} pairs: ShardedPairedSW on "
        f"{MESH_SHARDS} shards of cuda:0 == PairedGraphSW (5-tuples "
        f"identical, tolerance 0); K1 and table kernel launches "
        f"{launches['sharded']} = "
        f"{n_rounds} rounds x {MESH_SHARDS} shards - {fillers} empty "
        f"shards of the last round (one launch per slot), against "
        f"{launches['single']} unsharded; wall s sharded "
        f"{', '.join(f'{x:.3f}' for x in secs['sharded'])}, unsharded "
        f"{', '.join(f'{x:.3f}' for x in secs['single'])} (one card: the "
        f"difference is the sharding's host cost) [{card}]")


def _sharded_pipeline(card: str, wl: str, events):
    """(b): run_grmpy on the first SHARDED_EVENTS events over the mesh,
    then over the default mesh: equal genotypes, zero unexpected
    misses."""
    import copy

    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.ops.multi_sw import paired_fill
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy

    opts, descs = _first_events_graphs(wl, events, SHARDED_EVENTS)
    manifest = load_manifest(opts.manifest)
    results, secs, launches = {}, {}, {}
    for name, mesh in (("sharded", _mesh()), ("default", None)):
        paired_fill.launches = 0
        t0 = time.perf_counter()
        results[name] = run_grmpy(copy.deepcopy(descs), opts.reference,
                                  manifest, None, GrmpyParameters(),
                                  device="cuda", mesh=mesh)
        secs[name] = time.perf_counter() - t0
        launches[name] = paired_fill.launches
    if json.dumps(_strip_engine(results["sharded"]), sort_keys=True) != \
            json.dumps(_strip_engine(results["default"]), sort_keys=True):
        raise AssertionError("run_grmpy over the mesh != default mesh")
    if launches["sharded"] <= launches["default"]:
        raise AssertionError(f"K1 launches {launches}")
    _check_against_truth("sharded", opts, manifest, results["sharded"],
                         events)
    say(f"[sharded] (b) run_grmpy, {SHARDED_EVENTS} events: mesh of "
        f"{MESH_SHARDS} shards {secs['sharded']:.2f}s with "
        f"{launches['sharded']} K1 launches == default mesh "
        f"{secs['default']:.2f}s with {launches['default']} [{card}]")


def _multihost(card: str, wl: str):
    """(c): two processes (gloo, file:// rendezvous, both on cuda:0) run
    run_grmpy_multihost over every event; process 0's merged JSON ==
    phase 4's genotypes."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_multihost import WORKER_TIMEOUT_S, run_workers

    out = os.path.join(wl, "multihost.json")
    with tempfile.TemporaryDirectory() as rdv_dir:
        t0 = time.perf_counter()
        logs = run_workers(wl, out, os.path.join(rdv_dir, "rdv"), "cuda")
        elapsed = time.perf_counter() - t0
    for rank, (rc, log) in enumerate(logs):
        if rc != 0:
            raise AssertionError(f"multihost worker {rank}: rc {rc}\n"
                                 f"{log[-3000:]}")
    with open(out) as f:
        merged = json.load(f)
    with gzip.open(os.path.join(wl, "out_cuda", "genotypes.json.gz"),
                   "rt") as f:
        single = json.load(f)
    if json.dumps(_strip_engine(merged), sort_keys=True) != json.dumps(
            _strip_engine(single), sort_keys=True):
        raise AssertionError("multihost merge != phase 4's genotypes")
    say(f"[multihost] (c) 2 processes over gloo on cuda:0, {len(merged)} "
        f"events in {elapsed:.2f}s (process start and rendezvous "
        f"included; timeout {WORKER_TIMEOUT_S}s each): merged == phase "
        f"4's genotypes apart from the engine marker [{card}]")


def _dryrun_and_entry(card: str):
    """(d): dryrun_multichip over the mesh on phase 11's workload, and
    entry("cuda")'s K3 fill == its plain fill."""
    import torch

    from paragraph_tpu_torch.graft_entry import dryrun_multichip, entry
    from paragraph_tpu_torch.ops.multi_sw import paired_fill
    from paragraph_tpu_torch.ops.pallas_sw import (GraphFillTables,
                                                   graph_fill,
                                                   graph_fill_reference)

    paired_fill.launches = 0
    t0 = time.perf_counter()
    summary = dryrun_multichip(MESH_SHARDS, POP_WORKLOAD, mesh=_mesh())
    say(f"[dryrun] (d) dryrun_multichip({MESH_SHARDS}) on {POP_WORKLOAD}: "
        f"{summary}, sharded == serial, merged edge counts, device engine "
        f"== host on every confident PASS call; "
        f"{time.perf_counter() - t0:.2f}s, K1 launches "
        f"{paired_fill.launches} [{card}]")
    fn, args = entry("cuda")
    before = graph_fill.launches
    got = fn(*args)
    launches = graph_fill.launches - before
    want = graph_fill_reference(GraphFillTables(*args))
    if launches != 1 or not torch.equal(got, want):
        raise AssertionError(f"entry: {launches} K3 launches, or K3 != its "
                             "plain fill")
    say(f"[entry] entry('cuda'): K3 {tuple(got.shape)} == plain fill, "
        f"scores {int(got[0].min())}-{int(got[0].max())} [{card}]")


def _profile_and_prof_host(card: str, wl: str, events):
    """(e): a PROFILE_EVENTS-event multigrmpy under PARAGRAPH_TPU_PROFILE
    (its Chrome trace must name the paired kernel), then the host
    profiler by path on PROF_HOST_EVENTS events."""
    import tempfile

    from paragraph_tpu_torch.pipeline.multigrmpy import run
    from paragraph_tpu_torch.utils.profiling import ENV_VAR

    vcf = _write_first_events_vcf(wl, events, PROFILE_EVENTS)
    with tempfile.TemporaryDirectory() as trace_dir:
        os.environ[ENV_VAR] = trace_dir
        try:
            t0 = time.perf_counter()
            run(_options(wl, os.path.join(wl, "profiled"), vcf),
                device="cuda")
            elapsed = time.perf_counter() - t0
        finally:
            del os.environ[ENV_VAR]
        traces = [os.path.join(root, f)
                  for root, _, files in os.walk(trace_dir) for f in files
                  if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"profile: traces {traces}")
        with open(traces[0]) as f:
            trace = json.load(f)
    kernels = [e for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    paired = [e for e in kernels if "paired_sw" in e.get("name", "")]
    if not paired:
        raise AssertionError(f"the trace names no paired_sw kernel "
                             f"({len(kernels)} kernel events)")
    say(f"[profile] (e) multigrmpy, {PROFILE_EVENTS} events under "
        f"{ENV_VAR}: {elapsed:.2f}s; trace {os.path.basename(traces[0])} "
        f"with {len(kernels)} kernel events, {len(paired)} paired_sw "
        f"({sum(e.get('dur', 0) for e in paired) / 1e3:.3f} ms on the "
        f"device) [{card}]")
    proc = subprocess.run(
        [sys.executable, "paragraph_tpu_torch/tools/prof_host.py",
         "--events", str(PROF_HOST_EVENTS), "--workload", wl,
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"prof_host: rc {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    per_event = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"[prof_host] {PROF_HOST_EVENTS} events of {wl}: "
        f"{json.dumps(per_event)} [{card}]")


def phase_sharding(card: str, wl: str, events) -> None:
    """Phase 13: the sharded scorer, the pipeline over a mesh, two
    processes, the dry run and entry, the profile and the host
    profiler."""
    t_start = time.perf_counter()
    _sharded_scorer(card, wl)
    _sharded_pipeline(card, wl, events)
    _multihost(card, wl)
    _dryrun_and_entry(card)
    _profile_and_prof_host(card, wl, events)
    say(f"[sharding] phase 13 took {time.perf_counter() - t_start:.1f}s; "
        f"one card, so no speed over several cards is measured")


# --------------------------------------------------------------- phase 14


def _run_bench():
    """(exit code, stdout, stderr) of python -m
    paragraph_tpu_torch.tools.bench on the card with TMPDIR=BENCH_TMP, in
    a session of its own so that a timeout stops its children too."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paragraph_tpu_torch.tools.bench"], cwd=ROOT,
        env=dict(os.environ, TMPDIR=BENCH_TMP), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"tools/bench.py took over {BENCH_TIMEOUT_S}s")
    return proc.returncode, out, err


def _bench_dispatch_alone(card: str, n_reads: int, clock_hz: float):
    """K1 alone on tools/bench.py's dispatch, in this process: kernel ==
    plain, both timed, with the bound; returns the JAX bench's cells of
    the dispatch and the kernel's ms."""
    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  paired_fill_reference)
    from paragraph_tpu_torch.tools import bench, kbench

    sw, reads = kbench.build(n_reads=n_reads, device="cuda")
    tables, _ = kbench.bench_tables(sw, reads)
    _compare(paired_fill, paired_fill_reference, tables, "bench dispatch")
    kernel_ms, plain_ms = _time_fill(paired_fill, paired_fill_reference,
                                     tables, 10)
    bound_ms, bound_by = fill_bound(tables, clock_hz)
    cells = bench.paired_cells(sw, reads)
    say(f"[bench] K1 alone on that dispatch ({tables.col_idx.shape[0]} "
        f"lanes, {cells} cells by the JAX bench's count): kernel == plain; "
        f"kernel {kernel_ms:.3f} ms ({cells / kernel_ms / 1e9:.4g} "
        f"Tcells/s), bound {bound_ms:.3f} ms ({bound_by}), plain "
        f"{plain_ms:.1f} ms [{card}]")
    return cells, kernel_ms


def phase_bench(card: str, main_sv_s: float, pop, clock_hz: float) -> None:
    """Phase 14: the port's bench harnesses on the card, their population
    run held to phase 11's auto run (`pop`: SV x sample/s, confident
    calls, correct ones), and K1 alone on the bench's dispatch."""
    import torch

    from paragraph_tpu_torch.tools.bench_population import default_workload

    t_start = time.perf_counter()
    pop_wl = default_workload(POP_EVENTS, POP_SAMPLES, POP_SEED, BENCH_TMP)
    if not os.path.lexists(pop_wl):
        # the same generator and arguments as phase 11's workload
        os.symlink(POP_WORKLOAD, pop_wl)
    rc, out, err = _run_bench()
    try:
        line = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        raise AssertionError(f"tools/bench.py printed no line (rc {rc}): "
                             f"{err[-2000:]}")
    if rc != 0 or line.get("failed"):
        raise AssertionError(f"tools/bench.py failed (rc {rc}): {line}; "
                             f"{err[-2000:]}")
    if line["path"] != "cuda" or line["value"] <= 0 \
            or line["platform"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"tools/bench.py: not the card's result: "
                             f"{line}")
    say(f"[bench] line {json.dumps(line)}")
    ks = line["kernel_stats"]
    cells, kernel_ms = _bench_dispatch_alone(card, line["batch_reads"],
                                             clock_hz)
    say(f"[bench] cells/s {line['value']:.6g} on {line['batch_reads']} "
        f"reads (issued {ks['cells'] // ks['dispatches']} per dispatch), "
        f"best of {line['dispatches']} rounds of 5 dispatches: "
        f"{cells / line['value'] * 1e3:.3f} ms per dispatch against "
        f"{kernel_ms:.3f} for K1 alone; over its "
        f"{ks['dispatches']} "
        f"dispatches (warm-up included) tables "
        f"{ks['tables_s'] / ks['dispatches']:.4f}s, put "
        f"{ks['put_s'] / ks['dispatches']:.4f}s, device wait "
        f"{ks['device_wait_s'] / ks['dispatches']:.4f}s per dispatch "
        f"[{card}]")
    e2e = line.get("e2e_detail")
    if e2e is None or line.get("sv_genotyping_throughput_30x") is None:
        raise AssertionError(f"end-to-end bench: {line.get('e2e_error')}")
    if e2e["unexpected_misses"] != 0:
        raise AssertionError(f"end-to-end bench: {e2e}")
    say(f"[bench] SV/s {line['sv_genotyping_throughput_30x']} "
        f"({e2e['events']} events in {e2e['elapsed_s']}s, seed "
        f"{BENCH_E2E_SEED}; phase 4 in this "
        f"call: {main_sv_s:.2f}); accuracy {e2e['genotype_accuracy']}, "
        f"unexpected misses 0, peak device memory "
        f"{e2e['peak_device_mb']} MiB; stage seconds {e2e['stage_s']} "
        f"[{card}]")
    detail = line.get("population_detail")
    if detail is None or line.get("sv_sample_throughput") is None:
        raise AssertionError(
            f"population bench: {line.get('population_error')}")
    pop_rate, n_conf, n_ok = pop
    want = (n_conf, round(n_ok / n_conf, 4))
    got = (detail["confident_calls"], detail["confident_accuracy"])
    if got != want:
        raise AssertionError(f"population bench: confident calls and "
                             f"accuracy {got}, phase 11 {want}")
    say(f"[bench] SV x sample/s {line['sv_sample_throughput']} (phase 11 "
        f"in this call: {pop_rate:.2f}); confident calls {got[0]}, "
        f"accuracy {got[1]} (== phase 11); device engine jobs "
        f"{detail['gt_device_jobs']} in {detail['gt_device_call_s']}s; "
        f"stage seconds {detail['stage_s']} [{card}]")
    say(f"[bench] phase 14 took {time.perf_counter() - t_start:.1f}s")


def main() -> int:
    import logging

    # the port imports neither jax nor the JAX package: any such import
    # now fails the run
    sys.modules["jax"] = None
    sys.modules["paragraph_tpu"] = None
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")
    t_start = time.perf_counter()
    card = phase_device()
    pop_proc = start_pop_workload(POP_WORKLOAD)
    bench_proc = start_bench_workload()
    try:
        phase_build()
        clock_hz = sm_clock_hz()
        say(f"[device] max SM clock {clock_hz / 1e6:.0f} MHz")
        tables_entry = phase_table_kernel(card)
        err = phase_kernel_cases(card, clock_hz)
        events = ensure_workload(WORKLOAD)
        pop_events = finish_pop_workload(pop_proc, POP_WORKLOAD)
        finish_bench_workload(bench_proc)
    finally:
        for proc in (pop_proc, bench_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    err_full, kernel_ms, plain_ms, k1_tables = phase_full_dispatch(
        card, WORKLOAD, clock_hz)
    launches, tables_entry["launches"], main_sv_s = phase_main_path(
        card, WORKLOAD, events)
    phase_cuda_equals_cpu(card, WORKLOAD, events)
    opts, descs = _first_events_graphs(WORKLOAD, events, PER_EVENT_EVENTS)
    g_err, g_ms, g_plain_ms, k3_tables = phase_graph_kernel(card, opts,
                                                            descs, clock_hz)
    g_launches = phase_per_event(card, WORKLOAD, events, opts, descs)
    phase_paragraph_cli(card, WORKLOAD, opts, descs[:CLI_EVENTS])
    m_err, m_launches, m_ms, m_plain_ms, k2_tables = phase_multi_kernel(card)
    k4 = phase_kbench(card, clock_hz)
    pop = phase_population(card, POP_WORKLOAD, pop_events)
    mp_launches = phase_multiparagraph(card, WORKLOAD, events)
    say(f"[launches] graph_sw: {g_launches} on phase 7 (per-event path), "
        f"{mp_launches} on phase 12 (multiparagraph)")
    phase_sharding(card, WORKLOAD, events)
    phase_bench(card, main_sv_s, pop, clock_hz)
    say(f"[smoke] phases 1-14 took {time.perf_counter() - t_start:.1f}s")

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
         **bound(k2_tables)}, tables_entry, *k4]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
