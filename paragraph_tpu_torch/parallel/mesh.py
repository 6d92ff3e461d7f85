"""Population genotyping on one device.

Counterpart of ``sharded_population_genotyping`` in
``paragraph_tpu/parallel/mesh.py``, which shards a batch of (event x
sample x breakpoint) items over a device mesh. Items are independent, so
on one card the batch is one call of the float32 model over all of them;
the function keeps its name so that a reader finds the counterpart, and
takes a device in place of the mesh. ``make_mesh`` and
``merged_edge_counts`` (sharding over several cards) are not ported.
"""
from __future__ import annotations

import numpy as np


def sharded_population_genotyping(device, counts, depth, read_length,
                                  depth_sd, use_poisson, model,
                                  min_pass_gq: int = 10):
    """One step of genotyping/batched.py's full float32 model
    (likelihoods, best GT, GQ, NO_READS / GQ / BP_DEPTH filters, allele
    fractions, depth test) over N items on `device`: counts [N, A] and
    the per-item scalars [N] as numpy arrays or lists, the model tables
    (``model_from_parameters``) on that device. Returns the dict of
    result arrays as numpy."""
    import torch

    from .. import resolve_device
    from ..genotyping.batched import batched_genotype_full

    device = resolve_device(device)

    def place(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype)).to(device)

    out = batched_genotype_full(
        place(counts, np.int32), place(depth, np.float32),
        place(read_length, np.float32), place(depth_sd, np.float32),
        place(use_poisson, bool), model["gt_ploidy"], model["error_rates"],
        model["het_fractions"], model["log_priors"],
        min_pass_gq=min_pass_gq)
    return {k: v.cpu().numpy() for k, v in out.items()}
