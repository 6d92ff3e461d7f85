"""device_genotype_ms_per_sv.catalog150x8: milliseconds per event x
sample of the float32 device genotyping engine (parallel_grmpy.py's
device_genotype stage: every (event x sample x breakpoint) job of a run
through genotyping/device_engine.py, the results installed back) over
the window's completed jobs. None for any other driver or a job that
genotyped on the host."""

from benchmark import stages

read = stages.per_sv(("device_genotype",))
