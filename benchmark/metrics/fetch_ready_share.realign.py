"""fetch_ready_share.realign: share (%) of the window's paired dispatches
whose output had already reached the host when finalize_pairs fetched it:
100 x the scorer's fetch_ready (dispatches whose copy-out event had fired)
over dispatches. None where the scorer keeps no such counter."""


def read(run):
    s = run.get("scorer") or {}
    if not s.get("dispatches") or "fetch_ready" not in s:
        return None
    return 100.0 * s["fetch_ready"] / s["dispatches"]
