"""entry_ms_per_sv.catalog1k: milliseconds per catalogue event of the
entry and orchestrator (pipeline/multigrmpy.py) over the window's
completed jobs: the load, write_json and vcf_update stages plus each
job's wall time outside every stage, which holds spawning the workers
(benchmark/stages.py). None for any other driver."""

from benchmark import stages


def read(run):
    return stages.ms_per_event(run, stages.ENTRY)
