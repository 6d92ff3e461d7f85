"""extract_wait_ms_per_sv.catalog150x8: milliseconds per event x sample
the parent waits on its spawned workers (parallel_grmpy.py's
extract_wait and analysis_wait stages: every sample's read extraction,
then traceback and counting) over the window's completed jobs. None for
any other driver or a job off the pipelined path."""

from benchmark import stages

read = stages.per_sv(stages.WORKERS)
