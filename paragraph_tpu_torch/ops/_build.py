"""Build and load the CUDA kernels of ops/csrc/ at first use.

``nvcc`` compiles every ``.cu`` file under ``csrc/`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
library goes to ``paragraph_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources, so an edit rebuilds and an unchanged tree reuses it.
A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
_LIB_NAME = "libparagraph_tpu_torch_cuda.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: seconds the last build in this process took (None: loaded from disk)
build_seconds = None
#: nvcc's output of the last build in this process (ptxas register and
#: shared-memory report included)
build_log = ""


def _sources():
    return sorted(p for p in _CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.isfile(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / digest.hexdigest()[:16] / _LIB_NAME


def _compile(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The kernels' library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paired_sw_launch.restype = i
        lib.paired_sw_launch.argtypes = (
            [vp] * 9 + [i] + [vp] * 4 + [i] * 14 + [vp])
        lib.paired_sw_error_string.restype = ctypes.c_char_p
        lib.paired_sw_error_string.argtypes = [i]
        _lib = lib
        return lib


def error_string(lib, code: int) -> str:
    return f"{code} ({lib.paired_sw_error_string(code).decode()})"
