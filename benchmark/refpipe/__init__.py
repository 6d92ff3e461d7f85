"""A frozen copy of paragraph_tpu_torch's host pipeline, for the benchmark's
reference only.

Copied from the port's modules of the same relative paths (graph
conversion, BAM reading, read extraction, filters, traceback,
disambiguation, counting, the float64 genotyping engines and the float32
batch model), then cut: no native library (the traceback is the NumPy
``align/gssw.py``), no scorer (the benchmark's own fill in
``benchmark/reference.py`` hands its scores in), no device engine mesh.
Later changes to the port do not reach this copy, so it stays the
yardstick that decides ``correct``.
"""


def add_stats(total, stats: dict) -> None:
    """Sum one scorer's stats into `total` (no-op when it is None)."""
    if total is not None:
        for k, v in stats.items():
            total[k] = total.get(k, 0) + v
