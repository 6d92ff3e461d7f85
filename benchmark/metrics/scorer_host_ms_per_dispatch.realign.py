"""scorer_host_ms_per_dispatch.realign: milliseconds of host work per
paired dispatch of the scorer in the window: PairedGraphSW's tables_s
(read tables) plus put_s (copies queued to the card), over dispatches."""


def read(run):
    s = run.get("scorer") or {}
    if not s.get("dispatches"):
        return None
    return 1000.0 * (s["tables_s"] + s["put_s"]) / s["dispatches"]
