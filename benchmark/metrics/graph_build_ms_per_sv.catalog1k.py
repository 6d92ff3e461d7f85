"""graph_build_ms_per_sv.catalog1k: milliseconds per catalogue event of
the parent building each round's graphs and paired scorer
(parallel_grmpy.py's graph_build stage) over the window's completed
jobs. None for any other driver or a job off the pipelined path."""

from benchmark import stages


def read(run):
    return stages.ms_per_event(run, stages.GRAPHS)
