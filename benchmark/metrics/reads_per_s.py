"""reads_per_s: reads scored per second against their event graphs, each
read counted once (it is scored in its four orientations), over the
rounds finalised in the window and the whole window."""


def read(run):
    if run.get("driver") != "realign" or not run["reads"]:
        return None
    return run["reads"] / run["window_s"]
