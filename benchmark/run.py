"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (untimed, reported as ``setup_s`` from the process's start): the
card and the port's kernel library and the driver's warm-up. The seed's
inputs (made by ``generate.py`` or found in ``benchmark/.cache/inputs/``)
are the benchmark's own work: their seconds are left out of ``setup_s``
and reported as ``inputs_s`` on the record line. Then the window of
``--seconds`` (``drivers.py``), traced by torch.profiler with ``--trace
1``; then the check against the reference (``reference.py``,
``judge.py``), after the peak device memory is read and the program's
state is freed. The last line of standard output is
the result; the last lines of standard error are the numbers compared,
each beside its limit. Exits 2 without a result when the card is not
there, 3 when a module of ``jax``, ``jaxlib``, ``flax`` or
``paragraph_tpu`` is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "paragraph_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else 1e300


def card_detail() -> dict:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": out.stdout.strip(),
            "threads": len(os.sched_getaffinity(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def run_cell(cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float = None) -> dict:
    """Set up, measure and check one cell; returns the result dict (its
    keys in the order of the printed line) and the detail records."""
    from . import drivers, judge, trace

    t_start = T_START if t_start is None else t_start
    driver = drivers.make(cell, seed, device)
    try:
        driver.setup()
        # the seed's inputs are the benchmark's own work, not the program's
        setup_s = time.perf_counter() - t_start - driver.inputs_s
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        with trace.Trace(traced and device == "cuda") as tr:
            window_s = driver.window(seconds, tr)
        memory_peak = 0
        if device == "cuda":
            import torch

            memory_peak = int(torch.cuda.max_memory_allocated())
        summary = tr.read()
        driver.release()
        record = driver.run_record(window_s, summary)
        record["setup_s"] = setup_s
        record["inputs_s"] = driver.inputs_s
        check = driver.check()
        ok, rows = judge.verdict(check["numbers"], cell.config["limits"])
        correct = ok and check["failed"] == 0
        wanted = cell.per_layer if traced else cell.end_to_end
        metrics = {}
        for m in wanted:
            value = cell.readers[m["name"]](record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": _device_kind(device), "count": cell.chips,
               "memory_peak_bytes": memory_peak}
        result = {"correct": correct, "attempted": check["attempted"],
                  "failed": check["failed"], "metrics": metrics,
                  "device": dev}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = window_s
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        result["checks"] = {name: {"value": _finite(v), "limit": lim}
                            for name, v, lim in rows}
        return {"result": result, "details": driver.details(),
                "record": record, "checked": check["checked"]}
    finally:
        driver.close()


def _device_kind(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .cells import load_cell

    cell = load_cell(args.workload)
    set_cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    # one intra-op thread in this process and in the workers it spawns:
    # the scorer's host path ran faster and spread less so than on every
    # core, where its threads contend with each other and the workers
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        log(f"[bench] refused: the cell needs {cell.chips} CUDA card(s); "
            f"cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} visible")
        return 2
    import logging

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    log(json.dumps({"card": card_detail()}))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"[bench] refused: modules loaded in this process: {found}")
        return 3
    result = out["result"]
    for d in out["details"]:
        log(json.dumps({"detail": d}, default=str))
    log(json.dumps({"record": {k: v for k, v in out["record"].items()
                               if k != "trace"}}, default=str))
    log(json.dumps({"peak_device_bytes":
                    result["device"]["memory_peak_bytes"],
                    "checked": out["checked"]}))
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
