"""Opt-in torch.profiler capture of a pipeline run, and the program's
spans and counters.

Counterpart of ``paragraph_tpu/utils/profiling.py``. Set
``PARAGRAPH_TPU_PROFILE=/some/dir`` to wrap a run in a
``torch.profiler`` trace of the host and, where there is a card, of its
kernels (CPU and CUDA activities); the Chrome trace (``chrome://tracing``
or Perfetto) lands in ``/some/dir/<tag>/``. The trace never breaks the
run: a profiler that cannot start or cannot write its trace costs one
warning, and the run goes on. The run's own errors are not touched.

``span`` is the one timer of the program: it adds a block's wall seconds
into a stats dict (the scorers' and the pipeline's counters) and, only
while a torch profiler is recording, also puts the block on the trace as
a ``paragraph:<name>`` event. The scorers' spans carry their dispatch's
serial number after a ``#``, so a fetch can be joined to the launch it
fetches. ``timing_events`` and ``kernel_seconds`` time kernel launches
on the device with pairs of CUDA events.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import socket
from time import perf_counter
from typing import Dict, List, Optional

logger = logging.getLogger("paragraph_tpu")

ENV_VAR = "PARAGRAPH_TPU_PROFILE"


def _guard(what: str, step) -> bool:
    """Run one step of the trace; False, after one warning, if it
    failed."""
    try:
        step()
        return True
    except Exception as exc:  # noqa: BLE001 - the trace never breaks a run
        logger.warning("profiler %s failed (%s: %s); the run goes on "
                       "without a trace", what, type(exc).__name__, exc)
        return False


@contextlib.contextmanager
def maybe_profile(tag: str = "run"):
    """Context manager: a torch.profiler trace of the enclosed block,
    written to $PARAGRAPH_TPU_PROFILE/<tag>/<host>_<pid>.pt.trace.json
    when the variable is set; nothing otherwise."""
    out_dir = os.environ.get(ENV_VAR)
    if not out_dir:
        yield
        return
    target = os.path.join(out_dir, tag)
    prof = []

    def start():
        import torch.profiler

        os.makedirs(target, exist_ok=True)
        p = torch.profiler.profile(
            activities=sorted(torch.profiler.supported_activities(),
                              key=str))
        p.start()
        prof.append(p)

    if not _guard("start", start):
        yield
        return
    try:
        yield
    finally:
        path = os.path.join(
            target, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json")

        def stop():
            prof[0].stop()
            prof[0].export_chrome_trace(path)

        if _guard("capture", stop):
            logger.info("[profile] torch.profiler trace written to %s",
                        path)


#: prefix of the program's events on a torch.profiler trace
SPAN_PREFIX = "paragraph:"

_profiler_enabled = None
_event_scope = None

#: serial numbers of the scorers' dispatches, one sequence in a process
dispatch_serials = itertools.count(1)


def _bind_torch() -> None:
    global _profiler_enabled, _event_scope
    import torch
    from torch._C._profiler import _RecordFunctionFast

    _profiler_enabled = torch._C._autograd._profiler_enabled
    _event_scope = _RecordFunctionFast


class span:
    """``with span(name, stats, key):`` adds the block's wall seconds into
    ``stats[key]`` when `stats` is given. While a torch profiler records,
    the block is also the event ``paragraph:<name>`` (``#<serial>``
    appended when `serial` is given) on the trace's host timeline, nested
    in the span around it. The event is a function-scope record, not a
    user annotation: the profiler then copies nothing of it onto the
    device timeline, where it would read as device time. With no profiler
    the cost is one check and the two clock reads."""

    __slots__ = ("name", "stats", "key", "serial", "_t0", "_event")

    def __init__(self, name: str, stats: Optional[Dict] = None,
                 key: Optional[str] = None, serial: Optional[int] = None):
        self.name = name
        self.stats = stats
        self.key = key
        self.serial = serial

    def __enter__(self):
        if _profiler_enabled is None:
            _bind_torch()
        self._event = None
        if _profiler_enabled():
            name = SPAN_PREFIX + self.name
            if self.serial is not None:
                name += f"#{self.serial}"
            self._event = _event_scope(name)
            self._event.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self._t0
        if self._event is not None:
            self._event.__exit__(*exc)
        if self.stats is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + dt
        return False


#: free (start, end) pairs of timing CUDA events, by device index
_free_events: Dict[int, List] = {}


def timing_events(device):
    """A (start, end) pair of timing CUDA events for a launch on `device`,
    recorded around it on the launch's stream; None off a card. Read it
    with ``kernel_seconds`` once the caller has synchronised past it."""
    if device.type != "cuda":
        return None
    free = _free_events.get(device.index or 0)
    if free:
        return free.pop()
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def kernel_seconds(device, pair) -> float:
    """Device seconds between a pair's two events (0.0 for None); the
    pair goes back to its device's pool."""
    if pair is None:
        return 0.0
    _free_events.setdefault(device.index or 0, []).append(pair)
    return pair[0].elapsed_time(pair[1]) / 1e3
