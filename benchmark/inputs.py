"""The seed's inputs, made once per (configuration, mix, seed) and kept in
``benchmark/.cache/inputs/`` (a fixed directory of the checkout, listed in
``.gitignore``); the newest ``KEEP`` sets stay, older ones are removed."""
from __future__ import annotations

import os
import shutil
import sys
import time

from . import generate

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache",
                     "inputs")
KEEP = 6


def ensure(cfg: dict, mix: dict, seed: int) -> str:
    """The directory holding the inputs, generated if absent."""
    path = os.path.join(CACHE, f"{cfg['name']}__{mix['name']}__{seed}")
    if os.path.isfile(os.path.join(path, "inputs.json")):
        os.utime(path)
        return path
    os.makedirs(CACHE, exist_ok=True)
    part = path + ".part"
    shutil.rmtree(part, ignore_errors=True)
    t0 = time.perf_counter()
    generate.generate(part, cfg, mix, seed)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(part, path)
    print(f"[bench] inputs generated in {time.perf_counter() - t0:.2f}s",
          flush=True, file=sys.stderr)
    _evict()
    return path


def _evict() -> None:
    sets = sorted((os.path.getmtime(os.path.join(CACHE, d)), d)
                  for d in os.listdir(CACHE) if not d.endswith(".part"))
    for _, d in sets[:-KEEP]:
        shutil.rmtree(os.path.join(CACHE, d), ignore_errors=True)


def manifest(work: str, cfg: dict, samples) -> str:
    """samples.txt with this checkout's absolute BAM paths."""
    return generate.write_manifest(work, cfg, samples)
