"""scorer_ms_per_sv.catalog150x8: milliseconds per event x sample the
parent spends on the paired scorer (parallel_grmpy.py's score_dispatch
and device_wait+submit stages: PairedGraphSW's host tables, copies and
K1 launch, then the wait on its outputs) over the window's completed
jobs. None for any other driver or a job off the pipelined path."""

from benchmark import stages

read = stages.per_sv(("score_dispatch", "device_wait+submit"))
