"""device_idle_share.catalog150x8: device_idle_share.realign's reading
(one minus the union of the profiler's device intervals over the traced
window, in %) of a multigrmpy run, here of jobs whose parent scores and
genotypes on the card (its workers are spawned with CUDA_VISIBLE_DEVICES
empty). None for any other driver or an untraced run."""

from benchmark.cells import load_reader

_idle_share = load_reader("device_idle_share.realign")


def read(run):
    return _idle_share(run) if run.get("driver") == "multigrmpy" else None
