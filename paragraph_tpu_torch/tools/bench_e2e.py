#!/usr/bin/env python3
"""End-to-end benchmark of the port: SVs genotyped per second at 30x.

Counterpart of the repository's ``bench_e2e.py``, with its command line,
defaults, output keys and scoring. The full multigrmpy pipeline of the
port (VCF to graphs, BAM extraction, paired graph-SW scoring, host
analysis, genotyping, VCF out) runs on a synthetic mixed
DEL/INS/DUP/INV and nested DEL+SNP workload with planted genotypes
(``tests/tools/make_workload.py``), timed on the host clock. The
reference's published figure is 1-2 s per SV on one CPU core;
``vs_baseline`` uses the favourable 1.0 SV/s end of that range.

What the timed window holds. Before it: the workload (made by
``make_workload.py``'s command line in a child process, since that
generator imports the JAX package's BGZF reader; a ``truth.json`` of the
right length is reused), the device's start (``resolve_device``, one
small tensor operation on the device, a synchronize: what the JAX script
leaves out as its backend start) and, on ``cuda``, loading the kernel
library (``ops/_build.py``, which runs nvcc once per checkout; its
seconds go to stderr). Inside it, as in the JAX script: everything else
of ``multigrmpy.run``, the first kernel launches and the native
traceback library's first load included.

    python -m paragraph_tpu_torch.tools.bench_e2e [--events 1000]
        [--workload DIR] [--seed 11] [--device cuda]
    python3 paragraph_tpu_torch/tools/bench_e2e.py ...   (the same)

The workload defaults to ``$TMPDIR/bench_e2e_wl<events>_s<seed>``
(``/tmp`` when ``TMPDIR`` is unset). Prints one JSON line
``{"metric", "value", "unit", "vs_baseline"}``; on stderr the
``[pipeline]`` and ``[kernel]`` log lines, a detail line with the
accuracy, peak RSS and peak device memory, the per-kind recall and one
line per miss.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    # run by path: import the package from the checkout this file is in
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "paragraph_tpu_torch.tools"

from .kbench import device_name  # noqa: E402

REFERENCE_SV_PER_S = 1.0  # 1-2 s/SV on one core -> favourable end

#: the checkout this module sits in
CHECKOUT = Path(__file__).resolve().parents[2]
LOG_FORMAT = "[%(asctime)s] [%(name)s] [%(levelname)s] [%(message)s]"


def check_truth(genotypes_vcf, genotypes_json, events):
    """Score calls against the planted truth and CLASSIFY every miss.

    Returns (n_ok, misses) where each miss is a dict with a `reason`:
      - low_gq           GQ < 10: the model itself says the call is
                         uninformative (e.g. a DUP whose duplicated
                         segment is shorter than the read length, so no
                         read can span it)
      - filtered         FT != PASS (CONFLICT / BP_NO_GT / GQ ...): the
                         pipeline flagged the event as not confidently
                         callable
      - suspect          FT != PASS with GQ >= 10: flagged by the
                         pipeline while the model is confident
      - unexpected       a confident call (PASS, GQ >= 10) that
                         disagrees with the truth: a real defect
    A DEL+SNP event whose VCF call is "." with an UNMATCHED filter counts
    as correct when its breakpoints carry the planted genotype. Without a
    GQ field, GQ is the PL distance from the best genotype to the next.
    """
    calls = {}
    fts = {}
    gqs = {}
    with gzip.open(genotypes_vcf, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            fmt = parts[8].split(":")
            vals = parts[9].split(":")
            pos = int(parts[1])
            calls[pos] = vals[fmt.index("GT")]
            fts[pos] = vals[fmt.index("FT")] if "FT" in fmt else ""
            gq = -1
            if "GQ" in fmt:
                try:
                    gq = int(vals[fmt.index("GQ")])
                except ValueError:
                    pass
            elif "PL" in fmt:
                try:
                    pls = sorted(int(x) for x in
                                 vals[fmt.index("PL")].split(","))
                    gq = pls[1] - pls[0]
                except (ValueError, IndexError):
                    pass
            gqs[pos] = gq
    bp_gts = {}
    with gzip.open(genotypes_json, "rt") as f:
        for rec in json.load(f):
            for bp in rec["samples"]["sample"].get(
                    "breakpoints", {}).values():
                for a in set(bp["counts"]["alleles"]) - {"REF"}:
                    bp_gts.setdefault(a, set()).add(bp["gt"].get("GT", "."))
    n_ok = 0
    misses = []
    for i, ev in enumerate(events):
        got = calls.get(ev["pos"], "missing")
        want = ev["gt"]
        ok = (got == want or (got == "1/0" and want == "0/1")
              or (want == "0/0" and got in ("0/0", "./.")))
        if not ok and ev["kind"] == "DELSNP":
            allele = f"ev{i}:1"
            want_bp = {"0/1": f"REF/{allele}",
                       "1/1": f"{allele}/{allele}",
                       "0/0": "REF/REF"}[want]
            ok = (got == "." and "UNMATCHED" in fts.get(ev["pos"], "")
                  and bp_gts.get(allele) == {want_bp})
        if ok:
            n_ok += 1
            continue
        ft = fts.get(ev["pos"], "")
        gq = gqs.get(ev["pos"], -1)
        if ft not in ("", "PASS"):
            reason = "suspect" if gq >= 10 else "filtered"
        elif 0 <= gq < 10:
            reason = "low_gq"
        else:
            reason = "unexpected"
        misses.append({"event": i, "kind": ev["kind"], "pos": ev["pos"],
                       "want": want, "got": got, "FT": ft, "GQ": gq,
                       "reason": reason})
    return n_ok, misses


def per_kind_recall(events, misses):
    """{kind: {"total": N, "ok": N, "recall": f, <reason counts>}}."""
    missed_by_event = {m["event"]: m["reason"] for m in misses}
    table = {}
    for i, ev in enumerate(events):
        row = table.setdefault(ev["kind"], {"total": 0, "ok": 0})
        row["total"] += 1
        reason = missed_by_event.get(i)
        if reason is None:
            row["ok"] += 1
        else:
            row[reason] = row.get(reason, 0) + 1
    for row in table.values():
        row["recall"] = round(row["ok"] / row["total"], 4)
    return table


def workload_tools() -> Path:
    """``tests/tools`` of the checkout, which holds make_workload.py."""
    tools = CHECKOUT / "tests" / "tools"
    if not (tools / "make_workload.py").is_file():
        raise FileNotFoundError(
            f"{tools / 'make_workload.py'} not found: the bench harnesses "
            "make their workloads with the checkout's generator")
    return tools


def start_generator(argv) -> subprocess.Popen:
    """Start the workload generator's `argv` (after the interpreter) in a
    child process with the checkout on its path: the generator imports
    the JAX package's BGZF reader, which this process must not."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(CHECKOUT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen([sys.executable, *argv], cwd=CHECKOUT, env=env,
                            stdout=subprocess.DEVNULL)


def run_generator(argv, timeout: float = 1800) -> None:
    """Run start_generator(argv) to its end; raises if it fails or takes
    over `timeout` seconds."""
    proc = start_generator(argv)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    if rc != 0:
        raise subprocess.CalledProcessError(rc, argv)


def generator_argv(wl: str, n_events: int, seed: int, *extra) -> list:
    """make_workload.py's command line for `n_events` events into `wl`."""
    return [str(workload_tools() / "make_workload.py"), wl,
            "--events", str(n_events), "--seed", str(seed), *extra]


def default_workload(n_events: int, seed: int, tmpdir=None) -> str:
    """<tmpdir>/bench_e2e_wl<events>_s<seed>, in $TMPDIR by default."""
    return os.path.join(tmpdir or tempfile.gettempdir(),
                        f"bench_e2e_wl{n_events}_s{seed}")


def workload_events(wl: str, n_events: int):
    """The planted events of `wl`'s truth.json when it holds n_events,
    else None."""
    truth_path = os.path.join(wl, "truth.json")
    if not os.path.isfile(truth_path):
        return None
    with open(truth_path) as f:
        events = json.load(f)
    return events if len(events) == n_events else None


def load_events(wl: str, n_events: int, seed: int):
    """The planted events of the workload in `wl`: its truth.json when it
    holds n_events, else made anew by make_workload.py's command line."""
    events = workload_events(wl, n_events)
    if events is None:
        run_generator(generator_argv(wl, n_events, seed))
        with open(os.path.join(wl, "truth.json")) as f:
            events = json.load(f)
    return events


def start_device(device):
    """Resolve `device`, start it with one small tensor operation and a
    synchronize and, on cuda, load the kernel library (building it with
    nvcc if this checkout has none yet). Everything here stays out of the
    timed window; the library's seconds go to stderr."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    (torch.zeros((8, 128), device=dev) + 1).cpu()
    if dev.type != "cuda":
        print("[bench] kernel library: none on cpu (the plain fill)",
              file=sys.stderr, flush=True)
        return dev
    torch.cuda.synchronize(dev)
    from ..ops import _build

    t0 = time.perf_counter()
    _build.load()
    how = ("already built" if _build.build_seconds is None
           else f"nvcc {_build.build_seconds:.2f}s")
    print(f"[bench] kernel library: {how}, loaded in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr, flush=True)
    return dev


def reset_peak_memory(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_device_mb(dev):
    """torch.cuda.max_memory_allocated in MiB, or None on the CPU."""
    import torch

    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)


def stage_seconds(kernel_stats: dict) -> dict:
    """The pipelined path's stage seconds of a run, rounded ({} on the
    batch path)."""
    return {k: round(v, 3)
            for k, v in sorted(kernel_stats.get("stage_s", {}).items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench_e2e")
    ap.add_argument("--events", type=int, default=1000)
    ap.add_argument("--workload", default="",
                    help="existing workload dir (else generated in "
                         "$TMPDIR)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    wl = args.workload or default_workload(args.events, args.seed)
    events = load_events(wl, args.events, args.seed)

    # stage breakdown ([pipeline] stage seconds and [kernel] lines from
    # pipeline/parallel_grmpy.py) goes to stderr
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=LOG_FORMAT)

    dev = start_device(args.device)

    from ..pipeline.multigrmpy import MultigrmpyOptions, run

    stats = {}
    reset_peak_memory(dev)
    t0 = time.perf_counter()
    result = run(MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, "out_bench"),
        split_type="superloci",
    ), device=dev, kernel_stats=stats)
    elapsed = time.perf_counter() - t0

    n_ok, misses = check_truth(result["genotypes_vcf"],
                               result["genotypes_json"], events)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    rss_child = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024
    sv_per_s = len(events) / elapsed
    n_unexpected = sum(m["reason"] == "unexpected" for m in misses)
    print(json.dumps({
        "metric": "sv_genotyping_throughput_30x",
        "value": round(sv_per_s, 2),
        "unit": "SV/s",
        "vs_baseline": round(sv_per_s / REFERENCE_SV_PER_S, 2),
    }), flush=True)
    print(json.dumps({
        "events": len(events), "elapsed_s": round(elapsed, 2),
        "genotype_accuracy": round(n_ok / len(events), 4),
        "explained_accuracy": round(
            (len(events) - n_unexpected) / len(events), 4),
        "unexpected_misses": n_unexpected,
        "suspect_misses": sum(m["reason"] == "suspect" for m in misses),
        "peak_rss_main_mb": round(rss_mb, 1),
        "peak_rss_worker_mb": round(rss_child, 1),
        "peak_device_mb": peak_device_mb(dev),
        "device": device_name(dev),
        "stage_s": stage_seconds(stats),
    }), file=sys.stderr)
    print(json.dumps({"per_kind_recall": per_kind_recall(events, misses)}),
          file=sys.stderr)
    for m in misses:
        print(json.dumps({"miss": m}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
