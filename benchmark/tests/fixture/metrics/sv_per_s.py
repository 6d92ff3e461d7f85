"""sv_per_s: catalogue events genotyped per second (x samples), all the
completed jobs' events over the whole window (a fixture metric of the
tests, for the multigrmpy driver)."""


def read(run):
    if run.get("driver") != "multigrmpy":
        return None
    done = sum(j["ok"] for j in run["jobs"])
    return run["events"] * run["samples"] * done / run["window_s"] or None
