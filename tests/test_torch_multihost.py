"""The port's multi-host run: two processes over gloo == one process.

Two OS processes form a torch.distributed group (gloo, a ``file://``
rendezvous), genotype a strided share each of a make_workload run's
events on the CPU (parallel/multihost.py), and exchange their shares
with one all-gather. Process 0's merged, event-ordered output must equal
the port's single-process run and the JAX package's, apart from the
engine marker, as tests/test_multihost.py holds the JAX package's
jax.distributed run.

This file is also the worker: run as a script it joins the group and
runs ``run_grmpy_multihost``, importing nothing of jax or the JAX
package.

    python3 tests/test_torch_multihost.py INIT RANK WORLD WORKLOAD OUT DEVICE
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: seconds each worker may take, rendezvous included
WORKER_TIMEOUT_S = 300


def worker(argv) -> int:
    """Join the group, genotype this process's share of the workload's
    events on `device`, and (rank 0) write the merged results to OUT."""
    init, rank, world, wl, out, device = argv
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.parallel import multihost
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    multihost.initialize(init, int(world), int(rank))
    assert dist.get_world_size() == int(world)
    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, f"mh_out{rank}"), split_type="superloci")
    graphs = load_graph_description(opts)
    manifest = load_manifest(os.path.join(wl, "samples.txt"))
    results = multihost.run_grmpy_multihost(graphs, opts.reference,
                                            manifest, device=device)
    if int(rank) == 0:
        with open(out, "w") as f:
            json.dump(results, f, sort_keys=True)
    dist.destroy_process_group()
    return 0


def run_workers(wl: str, out: str, rdv: str, device: str, world: int = 2,
                env=None):
    """Start `world` workers on a file:// rendezvous at `rdv` and wait for
    each within WORKER_TIMEOUT_S; returns their (returncode, output).
    Each writes to a file of its own: a worker blocked on a full pipe
    would stall the group's all-gather."""
    logs = [tempfile.TemporaryFile() for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"file://{rdv}",
         str(rank), str(world), wl, out, device],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        for rank, log in enumerate(logs)]
    results = []
    try:
        for p, log in zip(procs, logs):
            p.wait(timeout=WORKER_TIMEOUT_S)
            log.seek(0)
            results.append((p.returncode,
                            log.read().decode(errors="replace")))
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return results


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip_engine(obj):
    if isinstance(obj, dict):
        return {k: _strip_engine(v) for k, v in obj.items()
                if k != "engine"}
    if isinstance(obj, list):
        return [_strip_engine(v) for v in obj]
    return obj


def _canon(results) -> str:
    return json.dumps(_strip_engine(json.loads(json.dumps(results))),
                      sort_keys=True)


def test_shard_events_without_a_group():
    """No group: rank 0 of 1 takes every event, as jax.process_index()
    and process_count() give outside jax.distributed."""
    from paragraph_tpu_torch.parallel.multihost import shard_events

    assert shard_events(5) == [0, 1, 2, 3, 4]
    assert shard_events(5, process_id=1, num_processes=2) == [1, 3]
    assert shard_events(7, process_id=2, num_processes=3) == [2, 5]


def test_two_process_gloo_matches_serial(tmp_path):
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from make_workload import generate

    wl = str(tmp_path / "wl")
    generate(wl, n_events=4, depth=10, seed=9)
    out = str(tmp_path / "merged.json")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for rc, log in run_workers(wl, out, str(tmp_path / "rdv"), "cpu",
                               env=env):
        assert rc == 0, log[-3000:]
    with open(out) as f:
        merged = json.load(f)
    assert len(merged) == 4

    from paragraph_tpu.genotyping.sample_info import (
        load_manifest as jax_manifest)
    from paragraph_tpu.pipeline.grmpy import run_grmpy as jax_run_grmpy
    from paragraph_tpu.pipeline.multigrmpy import (
        MultigrmpyOptions as JaxOptions,
        load_graph_description as jax_graphs)
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.pipeline.grmpy import run_grmpy
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, "serial_out"), split_type="superloci")
    serial = run_grmpy(load_graph_description(opts), opts.reference,
                       load_manifest(os.path.join(wl, "samples.txt")), None,
                       device="cpu")
    assert _canon(merged) == _canon(serial)
    jopts = JaxOptions(input=opts.input, reference=opts.reference,
                       output=os.path.join(wl, "jax_out"),
                       split_type="superloci")
    want = jax_run_grmpy(jax_graphs(jopts), opts.reference,
                         jax_manifest(os.path.join(wl, "samples.txt")), None)
    assert _canon(merged) == _canon(want)


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
