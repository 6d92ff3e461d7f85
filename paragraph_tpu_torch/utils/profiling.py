"""Opt-in torch.profiler capture of a pipeline run.

Counterpart of ``paragraph_tpu/utils/profiling.py``. Set
``PARAGRAPH_TPU_PROFILE=/some/dir`` to wrap a run in a
``torch.profiler`` trace of the host and, where there is a card, of its
kernels (CPU and CUDA activities); the Chrome trace (``chrome://tracing``
or Perfetto) lands in ``/some/dir/<tag>/``. The trace never breaks the
run: a profiler that cannot start or cannot write its trace costs one
warning, and the run goes on. The run's own errors are not touched.
"""
from __future__ import annotations

import contextlib
import logging
import os
import socket

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
