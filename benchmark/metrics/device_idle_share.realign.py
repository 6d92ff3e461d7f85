"""Share (%) of the traced window in which no operation ran on the card:
one minus the union of the profiler's device intervals (kernels, copies,
sets) over the window."""


def read(run):
    t = run.get("trace")
    if not t or run["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / run["window_s"])
