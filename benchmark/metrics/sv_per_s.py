"""sv_per_s: event genotypes per second over the multigrmpy driver's
window: catalogue events x samples x completed jobs over the window's
seconds; the window ends when the last job started in it ends. A job
with several samples counts each sample's genotype of an event once; a
job that raised counts nothing. None for any other driver."""

from benchmark import stages


def read(run):
    if run.get("driver") != "multigrmpy" or run["window_s"] <= 0:
        return None
    return (run["events"] * run["samples"] * len(stages.completed(run))
            / run["window_s"])
