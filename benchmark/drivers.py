"""The two drivers a traffic mix can name (its ``driver`` key), each with
set-up, the measured window, and the check of the window's outputs.

``multigrmpy``: a closed loop of jobs, each one
``paragraph_tpu_torch.pipeline.multigrmpy.run`` over the whole catalogue
(VCF in, VCF out) into its own directory under TMPDIR, started while the
clock is under the window's seconds; the window ends when the last
started job ends. Outputs are judged and deleted after the window.

``realign``: the catalogue's rounds of ``round_events`` events, each
round a ``PairedGraphSW`` over the benchmark's graph JSONs, built in
set-up; in the window the rounds' read batches go through
``score_pairs_device`` in turn, with one round in flight: each round is
finalised after the next is dispatched.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, List

import numpy as np

from . import inputs, judge, reference, roofline, scoring


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def start_device():
    """The card, started with one small operation, and the port's kernel
    library loaded (built by nvcc on a checkout's first run)."""
    import torch

    from paragraph_tpu_torch import resolve_device
    from paragraph_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    (torch.zeros((8, 128), device=dev) + 1).cpu()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _build.load()
    how = ("already built" if _build.build_seconds is None
           else f"nvcc {_build.build_seconds:.2f}s")
    log(f"[bench] kernel library: {how}, loaded in "
        f"{time.perf_counter() - t0:.2f}s")
    return dev


def check_rng(seed: int, salt: int) -> np.random.Generator:
    """The draws of the check, apart from the inputs' stream."""
    return np.random.default_rng([seed, salt])


def checked_events(events, mix: dict, seed: int) -> List[int]:
    """The events whose outputs the check compares: of each kind the
    longest, and ``check_per_kind`` - 1 others drawn from the seed."""
    rng = check_rng(seed, 1)
    checked: List[int] = []
    for kind in sorted({ev["kind"] for ev in events}):
        idx = [i for i, ev in enumerate(events) if ev["kind"] == kind]
        longest = max(idx, key=lambda i: (events[i]["size"], -i))
        rest = [i for i in idx if i != longest]
        take = min(mix["check_per_kind"] - 1, len(rest))
        checked += sorted([longest] + rng.choice(rest, take,
                                                 replace=False).tolist())
    return checked


def _free_device(device) -> None:
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()


def workers() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


class MultigrmpyDriver:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device_arg = device
        self.jobs: List[dict] = []
        self.tmp = tempfile.mkdtemp(prefix="bench_jobs_")

    # ---- set-up
    def setup(self) -> None:
        self.dev = (start_device() if self.device_arg == "cuda"
                    else self.device_arg)
        t0 = time.perf_counter()
        self.work = inputs.ensure(self.cfg, self.mix, self.seed)
        with open(os.path.join(self.work, "truth.json")) as f:
            self.events = json.load(f)
        with open(os.path.join(self.work, "inputs.json")) as f:
            self.samples = json.load(f)["samples"]
        self.manifest = inputs.manifest(self.work, self.cfg, self.samples)
        self.inputs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._run_job("warmup", os.path.join(self.work, "warmup.vcf"))
        log(f"[bench] warm-up job ({self.mix['warmup_events']} events): "
            f"{time.perf_counter() - t0:.2f}s")

    def options(self, vcf: str, out: str):
        from paragraph_tpu_torch.pipeline.multigrmpy import MultigrmpyOptions

        o = self.cfg["options"]
        return MultigrmpyOptions(
            input=vcf, manifest=self.manifest,
            reference=os.path.join(self.work, "ref.fa"), output=out,
            split_type=o["split_type"], read_length=o["read_length"],
            max_ref_node_length=o["max_ref_node_length"],
            max_reads_per_event=o["max_reads_per_event"],
            threads=o["threads"], gt_engine=o["gt_engine"])

    def _run_job(self, name: str, vcf: str) -> dict:
        from paragraph_tpu_torch.pipeline.multigrmpy import run

        out = os.path.join(self.tmp, name)
        stats: Dict = {}
        t0 = time.perf_counter()
        try:
            result = run(self.options(vcf, out), device=self.dev,
                         kernel_stats=stats)
        except Exception:  # a job that raises is a failed job, not a crash
            traceback.print_exc()
            result = None
        wall = time.perf_counter() - t0
        if name == "warmup":
            shutil.rmtree(out, ignore_errors=True)
        return {"name": name, "out": out, "result": result, "wall_s": wall,
                "stats": stats}

    # ---- window
    def window(self, seconds: float, trace) -> float:
        vcf = os.path.join(self.work, "candidates.vcf")
        t0 = time.perf_counter()
        with trace.span("window"):
            while time.perf_counter() - t0 < seconds:
                k = len(self.jobs)
                with trace.span(f"multigrmpy.run job {k}"):
                    self.jobs.append(self._run_job(f"job{k}", vcf))
        return time.perf_counter() - t0

    # ---- after the window
    def release(self) -> None:
        _free_device(self.device_arg)

    def units(self) -> int:
        """Event (x sample) genotypes of one job."""
        return len(self.events) * len(self.samples)

    def check(self) -> dict:
        """Judge every job's outputs (accuracy on a detail line, failures,
        the checked events' records), delete them, then compare with the
        reference."""
        checked = checked_events(self.events, self.mix, self.seed)
        failed = 0
        kept = []
        for job in self.jobs:
            res = job["result"]
            if res is None:
                failed += self.units()
                continue
            recs = self._records(res["genotypes_json"])
            failed += self._missing(res["genotypes_vcf"], recs)
            self._accuracy(job, res)
            kept.append({i: recs[i]["samples"] for i in checked
                         if i in recs})
            shutil.rmtree(job["out"], ignore_errors=True)
        t0 = time.perf_counter()
        ref = reference.event_records(
            self.work, self.cfg, checked, self.samples,
            processes=min(workers(), len(checked) * len(self.samples)),
            device=self.device_arg)
        log(f"[bench] reference over {len(checked)} events x "
            f"{len(self.samples)} samples: {time.perf_counter() - t0:.2f}s")
        numbers = judge.fold(
            judge.compare_samples(recs.get(i, {}), ref[i])
            for recs in kept for i in checked)
        if not kept:
            numbers = {k: float("inf") for k in self.cfg["limits"]
                       if k != "k1_outputs_differ"}
        return {"numbers": numbers, "failed": failed,
                "attempted": self.units() * len(self.jobs),
                "checked": len(checked) * len(self.samples) * len(kept)}

    @staticmethod
    def _records(path: str) -> Dict[int, dict]:
        """Records by event index (the block number of the record's ID)."""
        with gzip.open(path, "rt") as f:
            recs = json.load(f)
        return {int(r["graphinfo"]["ID"].rsplit(":", 1)[1]) - 1: r
                for r in recs}

    def _missing(self, vcf_path: str, recs: Dict[int, dict]) -> int:
        """Event x samples with no output record."""
        have = set()
        with gzip.open(vcf_path, "rt") as f:
            for line in f:
                if not line.startswith("#"):
                    have.add(int(line.split("\t", 2)[1]))
        missing = 0
        for i, ev in enumerate(self.events):
            if ev["pos"] not in have or i not in recs:
                missing += len(self.samples)
            else:
                missing += sum(s not in recs[i]["samples"]
                               for s in self.samples)
        return missing

    def _accuracy(self, job: dict, res: dict) -> None:
        """Against the planted truth (the first sample's), for the detail
        line; ``correct`` does not read it."""
        n_ok, misses = scoring.check_truth(res["genotypes_vcf"],
                                           res["genotypes_json"],
                                           self.events)
        job["accuracy"] = {
            "genotype_accuracy": n_ok / len(self.events),
            "unexpected_misses": sum(m["reason"] == "unexpected"
                                     for m in misses),
            "per_kind_recall": scoring.per_kind_recall(self.events,
                                                       misses)}

    def run_record(self, window_s: float, trace_summary) -> dict:
        """What the metric readers read."""
        return {"driver": "multigrmpy", "window_s": window_s,
                "events": len(self.events), "samples": len(self.samples),
                "jobs": [{"wall_s": j["wall_s"],
                          "stage_s": j["stats"].get("stage_s", {}),
                          "stats": {k: v for k, v in j["stats"].items()
                                    if k != "stage_s"},
                          "ok": j["result"] is not None}
                         for j in self.jobs],
                "trace": trace_summary}

    def details(self) -> List[dict]:
        return [{"job": j["name"], "wall_s": j["wall_s"],
                 "stage_s": j["stats"].get("stage_s", {}),
                 "accuracy": j.get("accuracy")} for j in self.jobs]

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


class RealignDriver:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device_arg = device
        self.kept: Dict[int, list] = {}
        self.done_rounds: List[int] = []
        self.reads_done = 0

    def setup(self) -> None:
        from paragraph_tpu_torch.graph.model import SequenceGraph
        from paragraph_tpu_torch.ops.multi_sw import PairedGraphSW

        self.dev = (start_device() if self.device_arg == "cuda"
                    else self.device_arg)
        t0 = time.perf_counter()
        self.work = inputs.ensure(self.cfg, self.mix, self.seed)
        with open(os.path.join(self.work, "graphs.json")) as f:
            self.graph_json = json.load(f)
        self.batches = self.read_batches(self.work, len(self.graph_json))
        self.inputs_s = time.perf_counter() - t0
        ref_path = os.path.join(self.work, "ref.fa")
        step = self.mix["round_events"]
        self.rounds = [list(range(a, min(a + step, len(self.graph_json))))
                       for a in range(0, len(self.graph_json), step)]
        self.scorers = [PairedGraphSW(
            [SequenceGraph.from_json(self.graph_json[e], ref_path)
             for e in r], device=self.dev) for r in self.rounds]
        with open(os.path.join(self.work, "truth.json")) as f:
            self.checked = set(checked_events(json.load(f), self.mix,
                                              self.seed))
        t0 = time.perf_counter()
        for k, r in enumerate(self.rounds):  # every round's shapes once
            self.scorers[k].score_pairs([self.batches[e] for e in r])
        log(f"[bench] warm-up pass over {len(self.rounds)} rounds: "
            f"{time.perf_counter() - t0:.2f}s")
        self.stats0 = self._stats()
        lens = [[len(x) for x in b] for b in self.batches]
        self.work_per_round = [roofline.needed_work(
            [lens[e] for e in r],
            [roofline.graph_bases(self.graph_json[e]) for e in r])
            for r in self.rounds]
        self.round_reads = [sum(len(self.batches[e]) for e in r)
                            for r in self.rounds]

    @staticmethod
    def read_batches(work: str, n_events: int) -> List[List[str]]:
        """Each event's reads (as strings) from reads.npz."""
        data = np.load(os.path.join(work, "reads.npz"))
        codes, offsets = data["codes"], data["offsets"]
        letters = np.frombuffer(b"ACGT", np.uint8)
        return [[row.tobytes().decode()
                 for row in letters[codes[offsets[e]:offsets[e + 1]]]]
                for e in range(n_events)]

    def _stats(self) -> dict:
        total: Dict[str, float] = {}
        for sc in self.scorers:
            for k, v in sc.stats.items():
                total[k] = total.get(k, 0) + v
        return total

    def _finish(self, k: int, handle, trace) -> None:
        with trace.span(f"finalize_pairs round {k}"):
            results = self.scorers[k].finalize_pairs(handle)
        for j, e in enumerate(self.rounds[k]):
            if e in self.checked:
                self.kept.setdefault(e, []).append(results[j])
        self.done_rounds.append(k)
        self.reads_done += self.round_reads[k]

    def window(self, seconds: float, trace) -> float:
        pending = None
        k = 0
        t0 = time.perf_counter()
        with trace.span("window"):
            # at least one whole pass over the catalogue, then rounds
            # while the clock is under `seconds`
            while (time.perf_counter() - t0 < seconds
                   or len(self.done_rounds) + 1 < len(self.rounds)):
                with trace.span(f"score_pairs_device round {k}"):
                    handle = self.scorers[k].score_pairs_device(
                        [self.batches[e] for e in self.rounds[k]])
                if pending is not None:
                    self._finish(*pending, trace)
                pending = (k, handle)
                k = (k + 1) % len(self.rounds)
            self._finish(*pending, trace)
        return time.perf_counter() - t0

    def release(self) -> None:
        self.stats1 = self._stats()
        self.scorers = None
        _free_device(self.device_arg)

    def check(self) -> dict:
        from .refpipe.io.fasta import FastaFile

        fasta = FastaFile(os.path.join(self.work, "ref.fa"))
        t0 = time.perf_counter()
        bad = 0
        for e in sorted(self.checked):
            g = reference.Graph.from_json(self.graph_json[e], fasta)
            ref = reference.four_orientations(g, self.batches[e],
                                              device=self.device_arg)
            for got in self.kept.get(e, []):
                bad += judge.compare_k1(got, ref)
        log(f"[bench] reference over {len(self.checked)} events: "
            f"{time.perf_counter() - t0:.2f}s")
        missing = [e for e in self.checked if e not in self.kept]
        numbers = {"k1_outputs_differ": bad if not missing
                   else float("inf")}
        return {"numbers": numbers, "failed": 0,
                "attempted": self.reads_done,
                "checked": sum(len(self.batches[e]) * len(self.kept.get(e,
                                                                         []))
                               for e in self.checked)}

    def run_record(self, window_s: float, trace_summary) -> dict:
        work = {"cells": 0, "ops": 0, "bytes": 0}
        for k in self.done_rounds:
            for key in work:
                work[key] += self.work_per_round[k][key]
        stats = {k: self.stats1.get(k, 0) - self.stats0.get(k, 0)
                 for k in self.stats1}
        record = {"driver": "realign", "window_s": window_s,
                  "reads": self.reads_done, "rounds": len(self.done_rounds),
                  "scorer": stats, "work": work, "trace": trace_summary}
        if trace_summary is not None:
            peaks = roofline.card_peaks()
            share = roofline.roofline_share(work, peaks,
                                            trace_summary["kernel_s"])
            if share is not None:
                record["k1_roofline"] = {**share, **peaks}
        return record

    def details(self) -> List[dict]:
        return [{"rounds": len(self.done_rounds), "reads": self.reads_done,
                 "events_checked": len(self.checked)}]

    def close(self) -> None:
        pass


DRIVERS = {"multigrmpy": MultigrmpyDriver, "realign": RealignDriver}


def make(cell, seed: int, device="cuda"):
    return DRIVERS[cell.traffic["driver"]](cell, seed, device)
