"""k1_roofline: the paired kernel's share (%) of its roofline in the
window: the least time the card could take for the needed work (the
benchmark's own count, roofline.py) over the profiler's CUDA kernel time.
The bound that sets it and the power limit are on the record line."""


def read(run):
    k1 = run.get("k1_roofline")
    return None if k1 is None else k1["share_pct"]
