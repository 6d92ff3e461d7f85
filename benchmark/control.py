"""The control of a cell: the reference put in the program's place at the
next lower precision, judged by the cell's own comparison; it has to come
out as not correct.

- genotyping: the reference's records with the likelihoods of the batch
  model in the configuration's ``control.genotyping`` (float32, where
  the configuration genotypes in float64);
- alignment scores: the reference's fill with every H value saturated as
  int8 holds it (127). int16 is no control here: it holds every score of
  reads up to 32,767 bases exactly (match 1), so it is not lower in
  effect.

    python3 -m benchmark.control --workload <cell> --seeds <n>,<n>,...

prints one JSON line per seed: the numbers, each limit, and whether the
comparison catches the control. The reference's fill runs on the card
where there is one, the rest on the host's cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import drivers, inputs, judge, reference

INT8_MAX = 127


def _dtype(name: str):
    import torch

    return None if name == "float32" else getattr(torch, name)


def as_tuple(out: dict):
    return tuple(out[k] for k in judge.K1_FIELDS)


def control_numbers(cell, seed: int, processes: int) -> dict:
    import torch

    cfg, mix = cell.config, cell.traffic
    work = inputs.ensure(cfg, mix, seed)
    with open(os.path.join(work, "truth.json")) as f:
        events = json.load(f)
    checked = drivers.checked_events(events, mix, seed)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if mix["driver"] == "realign":
        from .refpipe.io.fasta import FastaFile

        with open(os.path.join(work, "graphs.json")) as f:
            graphs = json.load(f)
        batches = drivers.RealignDriver.read_batches(work, len(graphs))
        fasta = FastaFile(os.path.join(work, "ref.fa"))
        bad = 0
        for e in checked:
            g = reference.Graph.from_json(graphs[e], fasta)
            ref = reference.four_orientations(g, batches[e], device=device)
            low = reference.four_orientations(g, batches[e],
                                              clamp_to=INT8_MAX,
                                              device=device)
            bad += judge.compare_k1(tuple(as_tuple(o) for o in low), ref)
        return {"k1_outputs_differ": bad}
    with open(os.path.join(work, "inputs.json")) as f:
        samples = json.load(f)["samples"]
    inputs.manifest(work, cfg, samples)
    ref = reference.event_records(work, cfg, checked, samples,
                                  processes=processes, device=device)
    precision = _dtype(cfg["control"]["genotyping"])
    low = reference.event_records(work, cfg, checked, samples,
                                  engine="batch", round_to=precision,
                                  processes=processes, device=device)
    return judge.fold(judge.compare_samples(low[i], ref[i])
                      for i in checked)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from .cells import load_cell

    cell = load_cell(args.workload)
    caught_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(cell, seed, drivers.workers())
        ok, rows = judge.verdict(numbers, cell.config["limits"])
        caught_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"],
                          "numbers": {n: [v, lim] for n, v, lim in rows},
                          "caught": not ok,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())
