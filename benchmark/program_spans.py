"""The program's own spans in a traced run: the ``paragraph:`` events that
the port's ``utils/profiling.py::span`` puts on the profiler's host
timeline, read against the device's intervals on the same clock.

- ``spans``: per span name (the dispatch serial after ``#`` dropped),
  count, total seconds and self seconds (the time no span nested inside
  it was open);
- ``idle_s``: the card's idle time inside the benchmark's ``window``
  span, split by a sweep over each idle interval: each part goes to the
  innermost program span open during that part, or to ``OUTSIDE``;
  ``longest_idle`` splits the five longest intervals the same way;
- ``fetch``: over every ``scorer.fetch#s`` span, the time the card ran a
  kernel launched inside a ``scorer.launch#t`` span with t > s (a later
  dispatch than the one fetched: ``behind_later_s``) or with t == s
  (``own_s``). A kernel is joined to the launch span in which its
  runtime launch call, found by correlation id, started on the host.

Device intervals are those ``trace.summarize`` counts (every CUDA event
but the benchmark's and the program's annotations). A run of a program
without such spans reads ``None``. The harness hands a metric's reader
only the run record, so ``of_run`` finds the profiler on the calling
frames: the ``Trace`` that ``run.run_cell`` holds.
"""
from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Tuple

from .trace import SPAN_PREFIX as BENCH_PREFIX
from .trace import _ns, _union

PREFIX = "paragraph:"
OUTSIDE = "outside the program's spans"
LAUNCH, FETCH = "scorer.launch", "scorer.fetch"

_cache: Dict[str, object] = {}


def _split(name: str) -> Tuple[str, Optional[int]]:
    base, _, serial = name[len(PREFIX):].partition("#")
    return base, int(serial) if serial.isdigit() else None


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def summarize_program(events) -> Optional[dict]:
    """The program's spans against the device's intervals (module
    docstring); None when the events hold no program span."""
    from torch.autograd import DeviceType

    spans = []      # (start, end, base, serial)
    device = []     # (start, end)
    kernels = []    # (start, end, correlation id)
    launches = {}   # correlation id -> host start of a runtime launch
    window = None
    on_device = 0
    for e in events:
        name = e.name()
        cuda = e.device_type() == DeviceType.CUDA
        if name.startswith(PREFIX):
            if cuda:
                on_device += 1
            else:
                spans.append((*_ns(e), *_split(name)))
            continue
        if name.startswith(BENCH_PREFIX):
            if not cuda and name == BENCH_PREFIX + "window":
                window = _ns(e)
            continue
        if cuda:
            a, b = _ns(e)
            if b <= a:
                continue
            device.append((a, b))
            if _is_kernel(name):
                kernels.append((a, b, e.correlation_id()))
        elif "LaunchKernel" in name:
            launches[e.correlation_id()] = e.start_ns()
    if not spans:
        return None
    spans.sort(key=lambda s: (s[0], -s[1]))  # an outer span first
    busy = _union(device)
    if window is None:
        window = (min(s[0] for s in spans), max(s[1] for s in spans))
    idle = _idle(busy, *window)
    self_s, idle_s = _sweep(spans, idle)
    names: Dict[str, List[float]] = {}
    for a, b, base, _ in spans:
        row = names.setdefault(base, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (b - a) / 1e9
    for base, s in self_s.items():
        names[base][2] = s
    longest = sorted(idle, key=lambda iv: iv[0] - iv[1])[:5]
    out = {
        "window_s": (window[1] - window[0]) / 1e9,
        "idle_total_s": sum(b - a for a, b in idle) / 1e9,
        "idle_s": dict(sorted(idle_s.items(), key=lambda kv: -kv[1])),
        "longest_idle": [[(b - a) / 1e9, _pairs(_sweep(spans, [(a, b)])[1])]
                         for a, b in longest],
        "spans": {k: names[k] for k in sorted(names)},
        "device_annotations": on_device,
    }
    out.update(_fetch(spans, kernels, launches))
    return out


def _pairs(d: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]


def _idle(busy, w0: int, w1: int) -> List[Tuple[int, int]]:
    """The parts of [w0, w1] outside the merged busy intervals."""
    idle, t = [], w0
    for a, b in busy:
        if b <= t:
            continue
        if a >= w1:
            break
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if t < w1:
        idle.append((t, w1))
    return idle


def _sweep(spans, idle):
    """(self seconds by span name, idle seconds by innermost open span
    name or OUTSIDE) over the boundaries of spans and idle intervals."""
    points = []
    for i, (a, b, _, _) in enumerate(spans):
        points.append((a, 1, i))
        points.append((b, 0, i))
    for a, b in idle:
        points.append((a, 3, -1))
        points.append((b, 2, -1))
    points.sort()
    open_spans: List[int] = []   # by start: the last is the innermost
    in_idle = False
    self_s: Dict[str, float] = {}
    idle_s: Dict[str, float] = {}
    t_prev = None
    for t, kind, i in points:
        if t_prev is not None and t > t_prev:
            dt = (t - t_prev) / 1e9
            label = spans[open_spans[-1]][2] if open_spans else OUTSIDE
            if open_spans:
                self_s[label] = self_s.get(label, 0.0) + dt
            if in_idle:
                idle_s[label] = idle_s.get(label, 0.0) + dt
        t_prev = t
        if kind == 1:
            open_spans.append(i)
        elif kind == 0:
            open_spans.remove(i)
        else:
            in_idle = kind == 3
    return self_s, idle_s


def _fetch(spans, kernels, launches) -> dict:
    """The fetch spans' time with a later (or the same) dispatch's
    kernels on the card; kernels joined to launch spans (docstring)."""
    fetches = [(a, b, s) for a, b, base, s in spans
               if base == FETCH and s is not None]
    if not fetches:
        return {}
    launch_spans = [(a, b, s) for a, b, base, s in spans
                    if base == LAUNCH and s is not None]
    starts = [a for a, _, _ in launch_spans]
    serial_of = []   # (kernel start, end, serial)
    for a, b, c in kernels:
        t = launches.get(c)
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0 and t <= launch_spans[k][1]:
            serial_of.append((a, b, launch_spans[k][2]))
    total = sum(b - a for a, b, _ in fetches)
    out = {"fetch": {"spans": len(fetches), "total_s": total / 1e9,
                     "kernels_joined": len(serial_of),
                     "kernels": len(kernels)}}
    if not serial_of:
        return out
    serial_of.sort()
    k_starts = [a for a, _, _ in serial_of]
    longest = max((b - a for a, b, _ in serial_of), default=0)
    later = own = 0
    for f0, f1, s in fetches:
        lo = bisect.bisect_left(k_starts, f0 - longest)
        hi = bisect.bisect_left(k_starts, f1)
        later += _covered([(a, b) for a, b, t in serial_of[lo:hi]
                           if t > s], f0, f1)
        own += _covered([(a, b) for a, b, t in serial_of[lo:hi]
                         if t == s], f0, f1)
    out["fetch"].update(behind_later_s=later / 1e9, own_s=own / 1e9)
    return out


def _covered(intervals, lo: int, hi: int) -> int:
    """Length of the union of intervals clipped to [lo, hi]."""
    clipped = [(max(a, lo), min(b, hi)) for a, b in intervals]
    return sum(b - a for a, b in _union([iv for iv in clipped
                                          if iv[1] > iv[0]]))


def _traced_events():
    """The events of the profiler that the run's Trace held, found on the
    calling frames; None when no frame holds one that recorded."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            prof = getattr(value, "prof", None)
            if type(value).__name__ == "Trace" and prof is not None:
                return prof.profiler.kineto_results.events()
        frame = frame.f_back
    return None


def of_run(run) -> Optional[dict]:
    """The summary of the traced run that `run` records (read once a run
    and logged as a detail line on standard error), or None."""
    if not run.get("trace"):
        return None
    if _cache.get("run") is not run:
        events = _traced_events()
        summary = None if events is None else summarize_program(events)
        _cache.update(run=run, summary=summary)
        if summary is not None:
            print(json.dumps({"detail": {"program_spans": summary}}),
                  file=sys.stderr, flush=True)
    return _cache["summary"]
