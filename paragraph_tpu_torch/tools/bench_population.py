#!/usr/bin/env python3
"""Population benchmark of the port: SV x sample throughput on a
multi-sample manifest.

Counterpart of the repository's ``bench_population.py``, with its command
line, defaults, output keys and scoring. The port's full multigrmpy
pipeline runs over N samples x M events with the auto-selected
genotyping engine (the float32 device engine for this shape:
``pipeline/grmpy.py`` gt_engine="auto"), timed on the host clock, and
per-sample calls are scored against the planted per-sample truth.

What the timed window holds. Before it: the workload (made in a child
process by ``tests/tools/make_workload.py``'s ``generate``, whose
command line has no sample count, since that generator imports the JAX
package's BGZF reader; one with the right events and samples is
reused), the device's start (``resolve_device``, one small tensor
operation, a synchronize: what the JAX script leaves out as its backend
start) and, on ``cuda``, loading the kernel library (``ops/_build.py``;
its seconds go to stderr). Inside it, as in the JAX script: everything
else of ``multigrmpy.run``, the first kernel launches and the device
engine's first call in the process included (``gt_device_call_s`` in the
detail line shows it).

    python -m paragraph_tpu_torch.tools.bench_population [--events 150]
        [--samples 8] [--seed 17] [--engine auto] [--device cuda]
    python3 paragraph_tpu_torch/tools/bench_population.py ...   (the same)

The workload is ``$TMPDIR/bench_pop_wl<events>x<samples>_s<seed>``
(``/tmp`` when ``TMPDIR`` is unset). Prints one JSON line
``{"metric": "sv_sample_throughput", ...}``; on stderr the ``[pipeline]``
and ``[kernel]`` log lines and a detail line with the accuracy, the
engine, the device engine's jobs and call seconds and the stage
seconds.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    # run by path: import the package from the checkout this file is in
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "paragraph_tpu_torch.tools"

from .bench_e2e import (LOG_FORMAT, peak_device_mb,  # noqa: E402
                        reset_peak_memory, run_generator, stage_seconds,
                        start_device, workload_tools)
from .bench_e2e import workload_events as e2e_workload_events  # noqa: E402
from .kbench import device_name  # noqa: E402

REFERENCE_SV_PER_S = 1.0  # per sample, same favourable end as bench_e2e

_GENERATE = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from make_workload import generate; "
             "generate(sys.argv[2], n_events=int(sys.argv[3]), "
             "seed=int(sys.argv[4]), n_samples=int(sys.argv[5]))")


def score_population(genotypes_vcf, events, sample_names):
    """Confident-call accuracy per sample vs the planted gts."""
    calls = {}
    with gzip.open(genotypes_vcf, "rt") as f:
        samples = []
        for line in f:
            if line.startswith("##"):
                continue
            parts = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                samples = parts[9:]
                continue
            fmt = parts[8].split(":")
            gt_i = fmt.index("GT")
            ft_i = fmt.index("FT") if "FT" in fmt else None
            per = {}
            for name, col in zip(samples, parts[9:]):
                vals = col.split(":")
                ft = vals[ft_i] if ft_i is not None else ""
                per[name] = (vals[gt_i], ft)
            calls[int(parts[1])] = per
    n_conf = n_ok = 0
    for ev in events:
        per = calls.get(ev["pos"], {})
        for name in sample_names:
            want = ev.get("gts", {}).get(name, ev["gt"])
            got, ft = per.get(name, ("missing", ""))
            if ft not in ("", "PASS", "."):
                continue  # unconfident; bench_e2e tracks these classes
            n_conf += 1
            if (got == want or (got == "1/0" and want == "0/1")
                    or (want == "0/0" and got in ("0/0", "./."))):
                n_ok += 1
    return n_conf, n_ok


def default_workload(n_events: int, n_samples: int, seed: int,
                     tmpdir=None) -> str:
    """<tmpdir>/bench_pop_wl<events>x<samples>_s<seed>, in $TMPDIR by
    default."""
    return os.path.join(tmpdir or tempfile.gettempdir(),
                        f"bench_pop_wl{n_events}x{n_samples}_s{seed}")


def generator_argv(wl: str, n_events: int, n_samples: int, seed: int):
    """The generator's argv for a population workload into `wl`: a -c
    child, since make_workload.py's command line takes no sample count."""
    return ["-c", _GENERATE, str(workload_tools()), wl, str(n_events),
            str(seed), str(n_samples)]


def workload_events(wl: str, n_events: int, n_samples: int):
    """The planted events of `wl`'s truth.json when it holds n_events
    events of n_samples samples, else None."""
    events = e2e_workload_events(wl, n_events)
    if events is None or len(events[0].get("gts", {})) != n_samples:
        return None
    return events


def load_events(wl: str, n_events: int, n_samples: int, seed: int):
    """The planted events of the population workload in `wl`, made anew
    unless its truth.json has n_events events of n_samples samples."""
    events = workload_events(wl, n_events, n_samples)
    if events is None:
        run_generator(generator_argv(wl, n_events, n_samples, seed))
        with open(os.path.join(wl, "truth.json")) as f:
            events = json.load(f)
    return events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench_population")
    ap.add_argument("--events", type=int, default=150)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    wl = default_workload(args.events, args.samples, args.seed)
    events = load_events(wl, args.events, args.samples, args.seed)
    sample_names = sorted(events[0]["gts"])

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
        gt_engine=args.engine,
    ), device=dev, kernel_stats=stats)
    elapsed = time.perf_counter() - t0

    n_conf, n_ok = score_population(result["genotypes_vcf"], events,
                                    sample_names)
    sv_samples = len(events) * len(sample_names)
    print(json.dumps({
        "metric": "sv_sample_throughput",
        "value": round(sv_samples / elapsed, 2),
        "unit": "SV*sample/s",
        "vs_baseline": round(sv_samples / elapsed / REFERENCE_SV_PER_S, 2),
    }), flush=True)
    print(json.dumps({
        "events": len(events), "samples": len(sample_names),
        "elapsed_s": round(elapsed, 2),
        "engine": args.engine,
        "confident_calls": n_conf,
        "confident_accuracy": round(n_ok / n_conf, 4) if n_conf else None,
        "gt_device_jobs": stats.get("gt_device_jobs", 0),
        "gt_device_call_s": round(stats.get("gt_device_call_s", 0.0), 4),
        "peak_device_mb": peak_device_mb(dev),
        "device": device_name(dev),
        "stage_s": stage_seconds(stats),
    }), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
