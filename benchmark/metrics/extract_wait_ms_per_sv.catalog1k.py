"""extract_wait_ms_per_sv.catalog1k: milliseconds per catalogue event
the parent waits on its spawned workers (parallel_grmpy.py's
extract_wait and analysis_wait stages: read extraction, then traceback,
counting and genotyping) over the window's completed jobs. None for any
other driver or a job off the pipelined path."""

from benchmark import stages


def read(run):
    return stages.ms_per_event(run, stages.WORKERS)
