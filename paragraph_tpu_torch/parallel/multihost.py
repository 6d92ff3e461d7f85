"""Multi-host runs: the events of one run split over processes.

Counterpart of ``paragraph_tpu/parallel/multihost.py``. The reference
scales to populations by farming out independent jobs and merging their
VCFs (``bcftools merge``); here that stays one program on
``torch.distributed``: every process genotypes a strided share of the
event list on its own cards (extraction and host analysis stay in the
process, which reads the BAMs it needs), and the per-event genotype JSONs
are exchanged with one all-gather, so that every process, process 0
among them, holds the whole event-ordered result. Nothing crosses
processes while events are scored or genotyped; the exchange carries
only the final JSON, as CPU tensors over gloo.
"""
from __future__ import annotations

import json
from datetime import timedelta
from typing import List, Optional

import numpy as np

#: seconds a process waits for the others to join the group, as the JAX
#: code's initialization_timeout
TIMEOUT_S = 300


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Join the process group (nothing if this process is in one).

    `coordinator_address` is ``host:port`` or a ``tcp://`` / ``file://``
    URL, with the group's size and this process's rank; with all three
    left out, torchrun's environment (``env://``) gives them."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=timedelta(seconds=TIMEOUT_S))


def _group():
    """(rank, world size): 0 and 1 when no group exists."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_events(n_events: int, process_id: Optional[int] = None,
                 num_processes: Optional[int] = None) -> List[int]:
    """Strided event assignment: process p takes events p::P. Striding
    (not contiguous blocks) balances events of mixed sizes, as the
    reference's work queue drains mixed jobs."""
    rank, world = _group()
    pid = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    return list(range(pid, n_events, n))


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """One bytes blob from each process, in rank order: the sizes first,
    then the blobs padded to the largest, as uint8 CPU tensors."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    data = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([data.numel()], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    buf = torch.zeros(max(1, max(sizes)), dtype=torch.uint8)
    buf[:data.numel()] = data
    gathered = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(gathered, buf)
    return [g[:n].numpy().tobytes() for g, n in zip(gathered, sizes)]


def run_grmpy_multihost(graph_descs: List[dict], reference_path: str,
                        manifest, genotyping_parameters=None,
                        parameters=None, device="cuda") -> List[dict]:
    """Event-ordered genotyping results over all processes of the group.
    Each process runs the single-host pipeline (pipeline/grmpy.py, over
    its own cards' mesh) on its share of the events; the shares merge
    with one all-gather. A missing event raises."""
    from ..pipeline.grmpy import run_grmpy

    n = len(graph_descs)
    mine = shard_events(n)
    local = run_grmpy([graph_descs[i] for i in mine], reference_path,
                      manifest, genotyping_parameters, parameters,
                      device=device)
    if _group()[1] == 1:
        return local

    payload = json.dumps({"events": mine, "results": local},
                         sort_keys=True).encode()
    merged: List[Optional[dict]] = [None] * n
    for blob in _allgather_bytes(payload):
        shard = json.loads(blob.decode())
        for gi, res in zip(shard["events"], shard["results"]):
            merged[gi] = res
    missing = [i for i, r in enumerate(merged) if r is None]
    if missing:
        raise RuntimeError(f"multihost merge missing events: {missing}")
    return merged
