#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (paragraph_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: torch / CUDA versions and the card's name and power limit
   (nvidia-smi); requires torch.cuda.is_available().
2. build: nvcc builds the paired graph-SW kernel from
   paragraph_tpu_torch/ops/csrc/ (first use), with its ptxas report.
3. kernel vs plain: seeded random cases (N bases, read lengths 6-150,
   empty pairs, pad tiles, reads longer than the graph, int16 and int32
   col_idx) and one full-size dispatch (the first dispatch of phase 4's
   first round) go through the kernel and the plain PyTorch fill on the
   same CUDA tensors; the [4, B] outputs must be identical (tolerance
   0: integer DP outputs). Times both at the full-size shape.
4. main path: the port's multigrmpy with device="cuda" on the repo's
   end-to-end workload (tests/tools/make_workload.py: 1000 mixed
   DEL/INS/DUP/INV/DEL+SNP events, 30x, 150 bp pairs, one sample, seed
   1; generated into smoke_workload/ and reused). Requires kernel
   launches on that run, zero unexpected misses against the planted
   truth (bench_e2e.check_truth) and the native traceback library.
5. kernel path == plain path end to end: the first 16 events through
   the port on cuda and on cpu give identical genotypes JSON and VCF
   records.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import gzip
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKLOAD = os.path.join(ROOT, "smoke_workload")
N_EVENTS = 1000
DEPTH = 30
SEED = 1
EQ_EVENTS = 16
KERNEL_SOURCE = "paragraph_tpu_torch/ops/csrc/paired_sw.cu"
KERNEL_REPLACES = "paragraph_tpu/ops/multi_sw.py:135"


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


def phase_build() -> None:
    from paragraph_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    nvcc = ("already built" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.2f}s")
    say(f"[build] {_build.library_path().relative_to(ROOT)}: {nvcc}, "
        f"loaded in {time.perf_counter() - t0:.2f}s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")


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
    from paragraph_tpu.graph.model import SequenceGraph

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


def _compare(tables, label):
    import torch

    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  paired_fill_reference)

    got = paired_fill(tables)
    torch.cuda.synchronize()
    want = paired_fill_reference(tables)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        bad = (got != want).any(0).nonzero().flatten()[:8].tolist()
        raise AssertionError(
            f"{label}: kernel != plain at lanes {bad}: "
            f"kernel {got[:, bad].tolist()} plain {want[:, bad].tolist()}")
    return err, got.shape[1]


def phase_kernel_cases(card: str):
    import dataclasses

    import torch

    max_err = 0
    for name, graphs, rpp in kernel_cases(seed=20261016):
        for ci, (tables, t) in enumerate(
                _case_tables(graphs, rpp, "cuda")):
            for idx_dtype in (torch.int16, torch.int32):
                tt = dataclasses.replace(
                    tables, col_idx=tables.col_idx.to(idx_dtype))
                err, lanes = _compare(tt, f"{name}[{ci}] {idx_dtype}")
                max_err = max(max_err, err)
            say(f"[kernel] case {name} chunk {ci}: {lanes} lanes, "
                f"M={t['m']}, col_idx {t['col_idx'].dtype}: kernel == "
                f"plain (int16 and int32 col_idx)")
    return max_err


def _first_round_tables(wl: str):
    """FillTables of the first dispatch of the main path's first round,
    built as the pipelined orchestrator builds it."""
    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.graph.model import SequenceGraph
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


def phase_full_dispatch(card: str, wl: str):
    import torch

    from paragraph_tpu_torch.ops.multi_sw import (paired_fill,
                                                  paired_fill_reference)

    tables, t = _first_round_tables(wl)
    B = tables.col_idx.shape[0]
    err, _ = _compare(tables, "full-size dispatch")
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
    say(f"[kernel] full-size dispatch: T={len(t['tile_col_len'])} tiles "
        f"B={B} lanes M={t['m']} N={tables.pred_tables.shape[1]} "
        f"P={tables.pred_tables.shape[2]} max_clen="
        f"{int(t['tile_col_len'].max())} cells={cells}: kernel == plain; "
        f"kernel {kernel_ms:.3f} ms ({cells / kernel_ms / 1e6:.2f} "
        f"Gcells/s), plain {plain_ms:.1f} ms [{card}]")
    return err, kernel_ms, plain_ms


# ---------------------------------------------------------------- phase 4


def _options(wl: str, out: str, vcf: str = "candidates.vcf"):
    from paragraph_tpu_torch.pipeline.multigrmpy import MultigrmpyOptions

    return MultigrmpyOptions(
        input=os.path.join(wl, vcf),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=out, split_type="superloci")


def ensure_workload(wl: str):
    sys.path.insert(0, os.path.join(ROOT, "tests", "tools"))
    from make_workload import generate

    truth = os.path.join(wl, "truth.json")
    if os.path.isfile(truth):
        with open(truth) as f:
            events = json.load(f)
        if len(events) == N_EVENTS:
            say(f"[workload] reusing {wl}")
            return events
    t0 = time.perf_counter()
    events = generate(wl, n_events=N_EVENTS, depth=DEPTH, seed=SEED)
    say(f"[workload] generated {N_EVENTS} events at {DEPTH}x in "
        f"{time.perf_counter() - t0:.1f}s")
    return events


def phase_main_path(card: str, wl: str, events):
    import torch

    from paragraph_tpu.align.native import native_available
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


def _write_first_events_vcf(wl: str, events) -> str:
    """candidates.vcf cut to the records of the first EQ_EVENTS events."""
    last = events[EQ_EVENTS - 1]["pos"]
    out = os.path.join(wl, f"first{EQ_EVENTS}.vcf")
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


def main() -> int:
    import logging

    # the port imports no jax, directly or through the host modules it
    # reuses from paragraph_tpu: any such import now fails the run
    sys.modules["jax"] = None
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")
    card = phase_device()
    phase_build()
    err = phase_kernel_cases(card)
    events = ensure_workload(WORKLOAD)
    err_full, kernel_ms, plain_ms = phase_full_dispatch(card, WORKLOAD)
    launches = phase_main_path(card, WORKLOAD, events)
    phase_cuda_equals_cpu(card, WORKLOAD, events)

    import torch

    say(json.dumps({"kernels": [{
        "name": "paired_sw", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(err, err_full), "ms": kernel_ms,
        "plain_ms": plain_ms}]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
