"""k1_ms_per_dispatch.realign: milliseconds of K1 on the card per paired
dispatch in the window: the scorer's k1_s (CUDA events recorded on the
launch's stream around each launch, read after the fetch), over
dispatches. None where the scorer keeps no such counter."""


def read(run):
    s = run.get("scorer") or {}
    if not s.get("dispatches") or not s.get("k1_s"):
        return None
    return 1000.0 * s["k1_s"] / s["dispatches"]
