"""The frozen yardstick of the realign cell against a hand count."""
from __future__ import annotations

from benchmark import roofline


def test_two_events_by_hand():
    g1 = {"nodes": [{"name": "L", "reference": "chrS:1-150"},
                    {"name": "A", "sequence": "ACGT"},
                    {"name": "R", "reference": "chrS:151-300"}]}
    g2 = {"nodes": [{"name": "L", "reference": "chrS:1001-1100"},
                    {"name": "R", "reference": "chrS:1101-1200"}]}
    assert roofline.graph_bases(g1) == 304
    assert roofline.graph_bases(g2) == 200
    work = roofline.needed_work([[150, 150], [100]], [304, 200])
    # cells: 4 orientations x (300 bases x 304 + 100 bases x 200)
    assert work["cells"] == 4 * (300 * 304 + 100 * 200) == 444800
    assert work["ops"] == 8 * 444800
    # bytes: bases once, both graph directions as 4-byte words, 4 int32
    # outputs per orientation
    assert work["bytes"] == (300 + 8 * 304 + 64 * 2) + (100 + 8 * 200 + 64)
    peaks = {"int32_ops_per_s": 132 * 64 * 1980e6, "bytes_per_s": 3.35e12}
    share = roofline.roofline_share(work, peaks, kernel_s=1e-3)
    assert share["bound"] == "operations"
    assert abs(share["share_pct"] - 100 * 8 * 444800 / (132 * 64 * 1980e6)
               / 1e-3) < 1e-9
    assert roofline.roofline_share(work, peaks, 0.0) is None
