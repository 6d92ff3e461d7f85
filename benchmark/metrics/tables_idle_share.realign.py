"""tables_idle_share.realign: share (%) of the traced window in which the
card is idle while the program's innermost open span is scorer.tables
(PairedGraphSW building a dispatch's read tables on the host); the sweep
of benchmark/program_spans.py. None where the program has no spans."""

from benchmark import program_spans


def read(run):
    summary = program_spans.of_run(run)
    if summary is None or run["window_s"] <= 0:
        return None
    return 100.0 * summary["idle_s"].get("scorer.tables", 0.0) \
        / run["window_s"]
