"""The traced run's reading of the device: torch.profiler (CUPTI) held in
memory over the window, never exported.

- busy: the union of the device's intervals (kernels, copies, sets);
- kernel time: the sum of the CUDA kernels' durations, whatever their
  names;
- breakdown: the device operations that took most time, and the longest
  idle gaps named by the benchmark's own span (``span``) that was open on
  the host when each gap began.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench:"


class Trace:
    """Context over the window; with on=False it records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.window_s = 0.0

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on:
            import torch

            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        """A named host span of the benchmark (recorded when tracing)."""
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def read(self) -> Optional[dict]:
        """busy_s, kernel_s, device_ops, idle_gaps of the window."""
        if self.prof is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events())


def _ns(event) -> Tuple[int, int]:
    start = event.start_ns()
    return start, start + event.duration_ns()


def _union(intervals: List[Tuple[int, int]]):
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> dict:
    from torch.autograd import DeviceType

    device, spans = [], []
    by_name: Dict[str, float] = {}
    kernel_ns = 0
    for e in events:
        if e.name().startswith(SPAN_PREFIX):
            # the benchmark's own spans, on the host and (as the
            # profiler's annotations) on the device timeline
            if e.device_type() != DeviceType.CUDA:
                spans.append((*_ns(e), e.name()[len(SPAN_PREFIX):]))
            continue
        if e.device_type() == DeviceType.CUDA:
            a, b = _ns(e)
            if b <= a:
                continue
            device.append((a, b))
            name = e.name()
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
            low = name.lower()
            if not (low.startswith("memcpy") or low.startswith("memset")):
                kernel_ns += b - a
    merged = _union(device)
    busy_ns = sum(b - a for a, b in merged)
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        label = "outside the benchmark's spans"
        open_spans = [s for s in spans if s[0] <= end < s[1]]
        if open_spans:
            # the innermost: the latest-started span still open
            label = max(open_spans)[2]
        gaps.append((label, (start - end) / 1e9))
    window = [s for s in spans if s[2] == "window"]
    if window and merged:
        # the window's edges: before its first device operation and after
        # its last
        w0, w1 = window[0][0], window[0][1]
        gaps.append(("window start", max(merged[0][0] - w0, 0) / 1e9))
        gaps.append(("window end", max(w1 - merged[-1][1], 0) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_ns / 1e9, "kernel_s": kernel_ns / 1e9,
            "device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]],
            "n_device_events": len(device)}
