"""The multigrmpy driver's jobs read by stage: the seconds that
``multigrmpy.run`` adds into ``kernel_stats["stage_s"]`` (the
``pipeline.<stage>`` spans of the port), each counted once, and under
``OUTSIDE`` the rest of each job's wall time, outside every stage
(spawning the workers is there). Over the window's completed jobs, in
milliseconds per catalogue event, or per event x sample (``per_sv``).

The layers: the entry and orchestrator (``pipeline/multigrmpy.py``)
own ``load``, ``write_json``, ``vcf_update`` and ``OUTSIDE``; the graphs
``graph_build``; the parent's waits on the spawned workers
``extract_wait`` and ``analysis_wait``. ``score_dispatch``,
``device_wait+submit`` and ``device_genotype`` belong to none of them.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

OUTSIDE = "outside"
ENTRY = ("load", "write_json", "vcf_update", OUTSIDE)
GRAPHS = ("graph_build",)
WORKERS = ("extract_wait", "analysis_wait")


def completed(run) -> List[dict]:
    """The completed jobs of a multigrmpy run record; [] for any other."""
    if run.get("driver") != "multigrmpy":
        return []
    return [j for j in run["jobs"] if j["ok"]]


def seconds(job: dict) -> Dict[str, float]:
    """A job's stage seconds and, under OUTSIDE, the rest of its wall
    time: together, its whole wall time."""
    return {**job["stage_s"],
            OUTSIDE: job["wall_s"] - sum(job["stage_s"].values())}


def split(jobs: List[dict], events: int) -> Dict[str, float]:
    """Every stage's milliseconds per event, and OUTSIDE's, over the
    completed jobs of `jobs` (run-record rows); {} where none completed."""
    done = [seconds(j) for j in jobs if j["ok"]]
    if not done:
        return {}
    out: Dict[str, float] = {}
    for s in done:
        for k, v in s.items():
            out[k] = out.get(k, 0.0) + v
    scale = 1000.0 / (events * len(done))
    return {k: v * scale for k, v in sorted(out.items())}


def ms_per_event(run, stages: Iterable[str]) -> Optional[float]:
    """Milliseconds per event of `stages` over the completed jobs: the
    sum of their entries in `split`; None where none of them is there."""
    by_stage = split(completed(run), run.get("events"))
    found = [by_stage[k] for k in stages if k in by_stage]
    return sum(found) if found else None


def per_sv(names: Iterable[str]):
    """A reader of `names`' milliseconds per event x sample (a job
    genotypes each event in each of the run's samples); None where
    `ms_per_event` is."""
    names = tuple(names)

    def read(run):
        ms = ms_per_event(run, names)
        return None if ms is None else ms / run["samples"]

    return read
