"""Device meshes, and the work that splits over one by rows.

Counterpart of ``paragraph_tpu/parallel/mesh.py``. A JAX mesh is the
process's device set, and one SPMD program runs over it. Here a *mesh*
is a plain ``list[torch.device]``: each shard's work is launched on its
own device, and a device may appear more than once (several shards on
one card, or ``[cpu] * 8`` on the CPU, where torch has one device). A
one-entry mesh runs exactly the single-device code.

- ``sharded_population_genotyping``: the float32 genotyping model over a
  batch of (event x sample x breakpoint) items, one call per shard;
- ``merged_edge_counts``: per-edge read counts summed over the shards'
  blocks of reads, then over the shards (the JAX code's ``psum``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def make_mesh(device="cuda", n_devices: Optional[int] = None) -> List:
    """Every visible device of `device`'s type, in index order (the CPU
    is one device), cut to the first `n_devices` when given."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if n_devices is not None:
        devices = devices[:n_devices]
    return devices


def _row_blocks(mesh, n_rows: int):
    """Equal row slices, one per shard; n_rows must split evenly, as a
    JAX array sharded over the mesh's axis must."""
    if not mesh:
        raise ValueError("empty mesh")
    if n_rows % len(mesh):
        raise ValueError(f"{n_rows} rows do not split over {len(mesh)} "
                         "shards")
    step = n_rows // len(mesh)
    return [slice(k * step, (k + 1) * step) for k in range(len(mesh))]


def sharded_population_genotyping(mesh, counts, depth, read_length,
                                  depth_sd, use_poisson, model,
                                  min_pass_gq: int = 10):
    """genotyping/batched.py's full float32 model (likelihoods, best GT,
    GQ, NO_READS / GQ / BP_DEPTH filters, allele fractions, depth test)
    over N items split over `mesh`: counts [N, A] and the per-item
    scalars [N] as numpy arrays or lists, N a multiple of the mesh's
    length (the caller pads), and the model tables
    (``model_from_parameters``). Shard k's rows go through one call on
    mesh[k], with the tables copied there; every call is issued before
    the first result is fetched. Items are independent, so no shard
    talks to another. Returns the dict of result arrays as numpy, rows
    in input order."""
    import torch

    from ..genotyping.batched import batched_genotype_full

    arrays = (np.asarray(counts, np.int32), np.asarray(depth, np.float32),
              np.asarray(read_length, np.float32),
              np.asarray(depth_sd, np.float32), np.asarray(use_poisson, bool))
    outs = []
    for device, rows in zip(mesh, _row_blocks(mesh, len(arrays[0]))):
        tables = [model[k].to(device) for k in (
            "gt_ploidy", "error_rates", "het_fractions", "log_priors")]
        outs.append(batched_genotype_full(
            *(torch.as_tensor(x[rows]).to(device) for x in arrays),
            *tables, min_pass_gq=min_pass_gq))
    return {k: np.concatenate([out[k].cpu().numpy() for out in outs])
            for k in outs[0]}


def merged_edge_counts(mesh, local_support):
    """Per-edge read counts [E] (int32, on mesh[0]) of `local_support`,
    the [B, E] 0/1 fragment-supports-edge rows: shard k sums its block of
    B / len(mesh) rows on mesh[k], and the partial sums are added on
    mesh[0], the JAX code's psum as plain tensor ops."""
    import torch

    sup = np.asarray(local_support)
    partial = [torch.as_tensor(sup[rows]).to(device).sum(0, dtype=torch.int32)
               for device, rows in zip(mesh, _row_blocks(mesh, len(sup)))]
    return torch.stack([p.to(mesh[0]) for p in partial]).sum(
        0, dtype=torch.int32)
