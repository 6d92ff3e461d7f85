"""Sorted-interval containers.

Equivalent of graph-tools' IntervalBuffer / IntervalList
(graph-tools src/graphutils/IntervalBuffer.cpp, 191 LoC, and
include/graphutils/IntervalList.hh): per-lane buffers of merged sorted
intervals with coverage/overlap queries and a streaming `advance` that
discards everything left of a position. Storage here is a flat sorted
list of disjoint non-adjacent [start, end] pairs per lane (the C++ keeps
a std::map keyed by end; the merge-on-add semantics, including joining
adjacent intervals, are identical).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import List, Tuple


class IntervalList:
    """Merged sorted intervals (IntervalList.hh:96-264)."""

    def __init__(self):
        # disjoint, non-adjacent, sorted by start; parallel end list for
        # bisect lookups
        self._ivs: List[List[int]] = []
        self._ends: List[int] = []

    def add(self, start: int, end: int) -> None:
        if start > end:
            return
        # first stored interval whose end >= start - 1 (the C++ joins a
        # LEFT-adjacent interval via lower_bound(start - 1) but merges
        # rightwards only on true overlap — the asymmetry is preserved)
        i = bisect_left(self._ends, start - 1)
        j = i
        new_start, new_end = start, end
        while j < len(self._ivs) and self._ivs[j][0] <= new_end:
            new_start = min(new_start, self._ivs[j][0])
            new_end = max(new_end, self._ivs[j][1])
            j += 1
        self._ivs[i:j] = [[new_start, new_end]]
        self._ends[i:j] = [new_end]

    def get(self, start: int, end: int) -> List[Tuple[int, int]]:
        """All stored intervals overlapping [start, end]."""
        if end < start:
            return []
        out = []
        i = bisect_left(self._ends, start)
        while i < len(self._ivs) and self._ivs[i][0] <= end:
            out.append((self._ivs[i][0], self._ivs[i][1]))
            i += 1
        return out

    def query(self, start: int, end: int) -> Tuple[int, int]:
        """Hull of all intervals overlapping [start, end]
        ((-1, -1) when none)."""
        ivs = self.get(start, end)
        if not ivs:
            return (-1, -1)
        return (min(s for s, _ in ivs), max(e for _, e in ivs))

    def remove_to(self, end: int) -> None:
        """Drop interval content at positions <= end
        (IntervalList.hh:232-254)."""
        if end < 0:
            self._ivs.clear()
            self._ends.clear()
            return
        i = bisect_left(self._ends, end)
        if i < len(self._ivs) and self._ivs[i][0] <= end:
            if self._ivs[i][1] > end:
                self._ivs[i][0] = end + 1
            else:
                i += 1
        del self._ivs[:i]
        del self._ends[:i]

    def intervals(self) -> List[Tuple[int, int]]:
        return [(s, e) for s, e in self._ivs]


class IntervalBuffer:
    """Per-lane interval tracking (IntervalBuffer.hh:48-93)."""

    def __init__(self):
        self._lanes: List[IntervalList] = []

    def add_interval(self, start: int, end: int, lane: int) -> None:
        if start > end:
            return
        while len(self._lanes) <= lane:
            self._lanes.append(IntervalList())
        self._lanes[lane].add(start, end)

    def advance(self, to: int) -> None:
        """Discard interval content left of `to`; -1 clears the buffer
        (IntervalBuffer.cpp:106-119)."""
        if to < 0:
            self._lanes = []
            return
        for lane in self._lanes:
            lane.remove_to(to - 1)

    def is_covered(self, start: int, end: int, lane: int) -> bool:
        """True when [start, end] lies inside ONE stored interval
        (IntervalBuffer.cpp:121-146); empty ranges count as covered."""
        if lane >= len(self._lanes):
            return False
        if end < start:
            return True
        ivs = self._lanes[lane].get(start, end)
        if len(ivs) != 1:
            return False
        s, e = ivs[0]
        return s <= start and e >= end

    def has_overlap(self, start: int, end: int, lane: int) -> bool:
        """True when [start, end] intersects any stored interval
        (IntervalBuffer.cpp:148-166)."""
        if lane >= len(self._lanes):
            return False
        if end < start:
            return True
        s, e = self._lanes[lane].query(start, end)
        return s >= 0 and e >= 0 and e - s + 1 > 0

    def get_intervals(self, lane: int) -> List[Tuple[int, int]]:
        if lane >= len(self._lanes):
            raise ValueError(f"Unknown lane: {lane}")
        return self._lanes[lane].intervals()
