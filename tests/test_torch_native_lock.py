"""The port's native traceback library under concurrent first builds.

Several processes that load the library from a checkout where it is not
built yet must all load it: one builds it while the others wait on the
build lock (paragraph_tpu_torch/align/native.py), and none falls back to
the Python traceback. The build's compiler is wrapped so that it writes
the library in place and slowly, as a linker writes its output; one
process starts loading at once and the others as soon as the library's
file appears, while it is still being written. Without the lock they
open the half-written library, fail, and fall back.
"""
import multiprocessing
import os
import shutil
import stat
import sys
import time

import pytest

SLOW_CXX = """#!{python}
import os, subprocess, sys, time
args = sys.argv[1:]
if "-o" not in args:
    sys.exit(subprocess.call([os.environ["SLOW_CXX_REAL"], *args]))
i = args.index("-o") + 1
out, args[i] = args[i], args[i] + ".%d.tmp" % os.getpid()
rc = subprocess.call([os.environ["SLOW_CXX_REAL"], *args])
if rc:
    sys.exit(rc)
with open(args[i], "rb") as f:
    data = f.read()
os.unlink(args[i])
step = len(data) // 8 + 1
with open(out, "wb") as f:
    for k in range(0, len(data), step):
        f.write(data[k:k + step])
        f.flush()
        time.sleep(0.5)
"""

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native")
N_PROCS = 4
#: seconds the racing processes may take together (one build of the library)
TIME_LIMIT = 300


def _load_from(native_dir, barrier, results, when_file_appears):
    """In a spawned process: point the port's native module at native_dir,
    wait for the others (and, if asked, for the library's file to
    appear), then load the library."""
    from paragraph_tpu_torch.align import native

    native._NATIVE_DIR = native_dir
    native._LIB_PATH = os.path.join(native_dir, "libparagraph_sw.so")
    barrier.wait()
    deadline = time.monotonic() + TIME_LIMIT
    while when_file_appears and not os.path.exists(native._LIB_PATH) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    lib = native._load_lib()
    results.put(lib is not None and lib._name == native._LIB_PATH)


def test_concurrent_first_builds_all_load(tmp_path, monkeypatch):
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if shutil.which("make") is None or cxx is None:
        pytest.skip("needs make and a C++ compiler")
    wrapper = tmp_path / "slow_cxx"
    wrapper.write_text(SLOW_CXX.format(python=sys.executable))
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(wrapper))
    monkeypatch.setenv("SLOW_CXX_REAL", cxx)
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in os.listdir(NATIVE):
        if name.endswith((".cpp", ".h", ".hpp")) or name == "Makefile":
            shutil.copy2(os.path.join(NATIVE, name), native_dir / name)
    assert not (native_dir / "libparagraph_sw.so").exists()

    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(N_PROCS)
    results = ctx.Queue()
    procs = [ctx.Process(target=_load_from,
                         args=(str(native_dir), barrier, results, k > 0))
             for k in range(N_PROCS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIME_LIMIT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    loaded = []
    while len(loaded) < N_PROCS and not results.empty():
        loaded.append(results.get(timeout=10))
    assert [p.exitcode for p in procs] == [0] * N_PROCS
    assert loaded == [True] * N_PROCS
    assert (native_dir / "libparagraph_sw.so").is_file()
