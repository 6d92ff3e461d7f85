#!/usr/bin/env python3
"""Benchmark of the port: graph Smith-Waterman fill throughput (cells/s)
on the card, then the end-to-end and population benches.

Counterpart of the repository's ``bench.py``, with its output keys and
scoring. A device worker, a child process under a 780 s watchdog, builds
the bench's case (``tools/kbench.py::build_case``: a ~600-base deletion
graph with source and sink, 8,192 reads of 150 bp), puts a
``PairedGraphSW`` over the graph on the device, warms it up with one
``score_pairs`` and then times ``repeats`` (6) rounds of 5
``score_pairs_device`` handles queued back to back, each then
``finalize_pairs``; the best round's seconds per dispatch give cells/s.
Cells are counted as the JAX script counts them: per read two fills on
the forward stream and two on the reversed one, ``reads x 2 x (col_len
of the graph + col_len of its reversal) x m``, with ``m`` the longest
read rounded up to 32.

What the timed window holds: each dispatch whole, as in the JAX script:
the host's tables, their copies to the device, the K1 launch and the
copy back of its outputs. Before it: the worker's start, the kernel
library's load (``ops/_build.py``), the scorer's graph tensors and the
warm-up dispatch. ``KERNEL_STATS`` on the worker's stderr (the scorer's
``engine_report()``, warm-up included) prices the host's part; the
parent adds it to its line as ``kernel_stats``.

There is no fallback. A worker that fails, hangs or reports a non-CUDA
device gives ``"failed": true``, a ``failure`` reason, ``value`` 0.0 and
exit code 1; nothing is rerun on the CPU. ``--device cpu``, asked for by
the caller, runs the worker on the plain fill at 2,048 reads and one
repeat; its line says ``"path": "cpu"`` and ``"failed": true``, so no CPU
number passes for the card's. When the card ran, the parent runs the
port's ``bench_e2e`` (1000 events) and ``bench_population`` (150 events x
8 samples) by their command lines under 600 s watchdogs and folds their
values and detail lines into its line.

The single-core gssw baseline (``bench_reference_cpu``) scores the
case's first 128 reads through ``tests/gssw_oracle.py``'s bridge, its
library built under ``$TMPDIR`` from the reference gssw sources that
module names. Where those sources are absent there is no baseline: the
line reads ``"baseline_cells_per_s": 0.0, "vs_baseline": 0.0``, and the
30x gate does not apply.

    python -m paragraph_tpu_torch.tools.bench [--device cuda]
    python3 paragraph_tpu_torch/tools/bench.py ...   (the same)

Prints one JSON line: ``{"metric": "graph_sw_cells_per_second", "value",
"unit", "vs_baseline", "path", "platform", ...}``.
"""
from __future__ import annotations

import argparse
import json
import os
import importlib.util
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    # run by path: import the package from the checkout this file is in
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "paragraph_tpu_torch.tools"

from .kbench import build_case  # noqa: E402

#: watchdog seconds of the device worker on the card and on the CPU, and
#: of each sub-bench
WORKER_TIMEOUT_S = 780
CPU_WORKER_TIMEOUT_S = 400
SUB_BENCH_TIMEOUT_S = 600
#: the worker's reads and timed rounds on the card and on the CPU
CARD_READS, CARD_REPEATS = 8192, 6
CPU_READS, CPU_REPEATS = 2048, 1
#: dispatches queued per timed round
DEPTH = 5
#: reads the gssw baseline scores (the case's first reads)
BASELINE_READS = 128


def paired_cells(sw, reads) -> int:
    """Cells of one dispatch of `reads` as the JAX bench counts them: per
    read 2 fills on the forward stream (read and reverse complement) and 2
    on the reversed stream, over the graph's columns and `m` read rows."""
    a = sw.chunk_arrays[0]
    m = ((max(len(r) for r in reads) + 31) // 32) * 32
    return len(reads) * 2 * (a.col_len[0] + a.col_len[1]) * m


def bench_device(g, reads, repeats=3, device="cuda"):
    """(cells/s, seconds per dispatch) of the paired scorer over graph `g`
    on `device`: the best of `repeats` rounds of DEPTH dispatches of
    `reads` queued back to back, each then finalized, after one warm-up
    dispatch. Prints the scorer's engine_report() on stderr as
    KERNEL_STATS."""
    from .. import resolve_device
    from ..ops.multi_sw import PairedGraphSW

    sw = PairedGraphSW([g], device=resolve_device(device))
    sw.score_pairs([reads])  # warm-up
    cells = paired_cells(sw, reads)
    elapsed = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        handles = [sw.score_pairs_device([reads]) for _ in range(DEPTH)]
        for h in handles:
            sw.finalize_pairs(h)
        elapsed = min(elapsed, (time.perf_counter() - t0) / DEPTH)
    print(f"KERNEL_STATS {json.dumps(sw.engine_report())}", file=sys.stderr,
          flush=True)
    return cells / elapsed, elapsed


def gssw_reference():
    """tests/gssw_oracle.py's GsswRef over a library built under $TMPDIR,
    or None where the reference gssw sources it names are absent."""
    path = Path(__file__).resolve().parents[2] / "tests" / "gssw_oracle.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location("gssw_oracle", path)
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    if not os.path.isfile(oracle._GSSW_C):
        return None
    # the oracle's own library path is fixed; build this one per $TMPDIR
    oracle._LIB = os.path.join(tempfile.gettempdir(), "libgssw_bench.so")
    try:
        return oracle.GsswRef()
    except (OSError, subprocess.CalledProcessError):
        return None


def bench_reference_cpu(ref_lib, g, reads, max_reads=BASELINE_READS):
    """Single-core gssw baseline (4 fills per read like GraphAligner) of
    `ref_lib` (gssw_reference()) on the first `max_reads` reads."""
    from ..align.graph_aligner import reverse_complement

    node_seqs = [g.node_seq(i) for i in range(g.num_nodes)]
    edges = g.edges()
    rg = g.reversed()
    rnode_seqs = [rg.node_seq(i) for i in range(rg.num_nodes)]
    redges = rg.edges()

    sample = reads[:max_reads]
    t0 = time.perf_counter()
    for r in sample:
        rc = reverse_complement(r)
        ref_lib.align(node_seqs, edges, r)
        ref_lib.align(node_seqs, edges, rc)
        ref_lib.align(rnode_seqs, redges, r[::-1])
        ref_lib.align(rnode_seqs, redges, rc[::-1])
    elapsed = time.perf_counter() - t0

    L = sum(len(s) for s in node_seqs)
    cells = sum(4 * L * ((len(r) + 15) // 16) * 16 for r in sample)
    return cells / elapsed


def device_worker(device: str, n_reads=None) -> int:
    """The watchdog's child: prints the cells/s and the device the scorer
    ACTUALLY ran on (the card's name, or cpu), so that a CPU number can
    never pass for the card's. `n_reads` defaults to the device's batch
    (CARD_READS or CPU_READS); the command line always takes the
    default."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    n_reads = n_reads or (CPU_READS if on_cpu else CARD_READS)
    repeats = CPU_REPEATS if on_cpu else CARD_REPEATS
    g, reads = build_case(n_reads=n_reads)
    cells_per_s, _ = bench_device(g, reads, repeats=repeats, device=dev)
    platform = "cpu" if on_cpu else torch.cuda.get_device_name(dev)
    print(f"DEVICE_RESULT {cells_per_s} {platform} {n_reads} {repeats}",
          flush=True)
    return 0


def parse_worker(stdout: str, stderr: str, returncode: int, device: str):
    """(result, None) from a device worker's output, or (None, why) when it
    printed no result or ran on another device than `device` asked for."""
    for line in stdout.splitlines():
        if not line.startswith("DEVICE_RESULT "):
            continue
        parts = line.split()
        # the card's name may hold spaces: it sits between the rate and
        # the two counts
        result = {"cells_per_s": float(parts[1]),
                  "platform": " ".join(parts[2:-2]),
                  "n_reads": int(parts[-2]),
                  "dispatches": int(parts[-1])}
        for err in stderr.splitlines():
            if err.startswith("KERNEL_STATS "):
                result["kernel_stats"] = json.loads(err.split(" ", 1)[1])
        if device == "cuda" and result["platform"] == "cpu":
            return None, ("device worker reported platform cpu where a "
                          "CUDA card was asked for")
        return result, None
    tail = stderr.strip().splitlines()[-1:] or ["no output"]
    return None, (f"device worker exited with code {returncode} and no "
                  f"result: {tail[0]}")


def run_worker(device: str):
    """(result, None) of a device worker in a child process under its
    watchdog, or (None, why) when it hung, failed or ran elsewhere."""
    argv = [sys.executable, os.path.abspath(__file__), "--device-worker",
            "--device", device]
    timeout = CPU_WORKER_TIMEOUT_S if device == "cpu" else WORKER_TIMEOUT_S
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, f"device worker timed out after {timeout} s"
    except OSError as exc:
        return None, f"device worker did not start: {exc}"
    return parse_worker(proc.stdout, proc.stderr, proc.returncode, device)


def run_sub_bench(script: str, args, detail_key: str):
    """(the JSON line, the detail line or None) of the port's `script` run
    by its command line under the sub-bench watchdog; raises on a timeout
    or a missing or malformed line."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name(script)), *args],
        capture_output=True, text=True, timeout=SUB_BENCH_TIMEOUT_S)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    for dline in proc.stderr.splitlines():
        if detail_key in dline:
            return line, json.loads(dline)
    return line, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-worker", action="store_true",
                    help="run as the watchdog's child")
    args = ap.parse_args(argv)
    if args.device_worker:
        return device_worker(args.device)

    result, failure = run_worker(args.device)
    card_ok = result is not None and args.device == "cuda"
    device_cells_per_s = result["cells_per_s"] if result else 0.0
    ref_lib = gssw_reference()
    baseline = bench_reference_cpu(
        ref_lib, *build_case(n_reads=BASELINE_READS)) if ref_lib else None
    vs = (device_cells_per_s / baseline) if baseline else 0.0
    out = {
        "metric": "graph_sw_cells_per_second",
        "value": round(device_cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(vs, 2),
        "path": "cuda" if card_ok else ("cpu" if result else "none"),
        "platform": result["platform"] if result else "none",
        "batch_reads": result["n_reads"] if result else 0,
        "dispatches": result["dispatches"] if result else 0,
        "baseline_cells_per_s": round(baseline or 0.0, 1),
    }
    if result and "kernel_stats" in result:
        out["kernel_stats"] = result["kernel_stats"]
    if card_ok:
        # the north-star system metric: a 1000-event end-to-end run in a
        # watchdogged child; a hung or failed run marks its keys, never
        # the bench
        try:
            e2e, detail = run_sub_bench("bench_e2e.py", ["--events", "1000"],
                                        '"genotype_accuracy"')
            out["sv_genotyping_throughput_30x"] = e2e["value"]
            out["e2e_vs_baseline"] = e2e["vs_baseline"]
            if detail is not None:
                out["e2e_detail"] = detail
        except (subprocess.TimeoutExpired, OSError, ValueError,
                IndexError, KeyError) as exc:
            out["sv_genotyping_throughput_30x"] = None
            out["e2e_error"] = f"{type(exc).__name__}: {exc}"
        # the population shape: 8 samples x 150 events through the
        # pipelined path and the device genotyping engine
        try:
            pop, detail = run_sub_bench(
                "bench_population.py", ["--events", "150", "--samples", "8"],
                '"confident_accuracy"')
            out["sv_sample_throughput"] = pop["value"]
            if detail is not None:
                out["population_detail"] = detail
        except (subprocess.TimeoutExpired, OSError, ValueError,
                IndexError, KeyError) as exc:
            out["sv_sample_throughput"] = None
            out["population_error"] = f"{type(exc).__name__}: {exc}"

    if not card_ok:
        out["failed"] = True
        out["failure"] = failure or (
            "device cpu asked for: the plain fill on the host, not the "
            "card's number")
    elif baseline and vs < 30:
        out["failed"] = True
        out["failure"] = (f"kernel throughput regression: {vs:.1f}x "
                          "baseline (threshold 30x)")
    print(json.dumps(out), flush=True)
    return 1 if out.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
