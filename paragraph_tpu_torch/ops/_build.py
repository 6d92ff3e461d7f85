"""Build and load the CUDA kernels of ops/csrc/ at first use.

``nvcc`` compiles every ``.cu`` file under ``csrc/`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. The
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp_dir, f"{p.stem}.o"), str(p)]
                for p in _sources() if p.suffix == ".cu"]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{log}")
        tmp_lib = os.path.join(tmp_dir, _LIB_NAME)
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", tmp_lib, *(cmd[-2] for cmd in cmds)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, out)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs) + proc.stdout + proc.stderr


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
        lib.multi_sw_launch.restype = i
        lib.multi_sw_launch.argtypes = [vp] * 10 + [i] * 13 + [vp]
        lib.graph_sw_launch.restype = i
        lib.graph_sw_launch.argtypes = [vp] * 10 + [i] * 11 + [vp]
        lib.paired_sw_error_string.restype = ctypes.c_char_p
        lib.paired_sw_error_string.argtypes = [i]
        _lib = lib
        return lib


def error_string(lib, code: int) -> str:
    return f"{code} ({lib.paired_sw_error_string(code).decode()})"


def launch(fn_name: str, dev, scratch_words: int, n_lanes: int, inputs,
           ints):
    """Launch one kernel of the library on dev's current stream: the C
    entry point takes `inputs` (tensors as pointers, ints as they are),
    an int32 scratch of `scratch_words` and the [4, n_lanes] int32
    output, then `ints` and the stream. Returns the output; raises if the
    launch is refused."""
    import torch

    scratch = torch.empty(scratch_words, dtype=torch.int32, device=dev)
    out = torch.empty((4, n_lanes), dtype=torch.int32, device=dev)
    lib = load()
    args = [x.data_ptr() if isinstance(x, torch.Tensor) else x
            for x in inputs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*args, scratch.data_ptr(),
                                    out.data_ptr(), *ints, stream)
    if err:
        raise RuntimeError(f"{fn_name} failed: {error_string(lib, err)}")
    return out
