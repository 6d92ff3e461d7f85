"""Population device genotyping: all events of a run, one call per model.

Counterpart of ``paragraph_tpu/genotyping/device_engine.py``. The
float64 engines (breakpoint_genotyper.py scalar, vectorized.py batch)
genotype one event at a time on the host for bit parity with the
reference (BreakpointGenotyper.cpp). This engine gathers every (event x
sample x breakpoint) job of a whole grmpy run, groups the jobs by model
signature (allele count, ploidy, rate tables), and evaluates each group in
one float32 step over the run's mesh, one call per shard
(parallel/mesh.py::sharded_population_genotyping). GL values agree with
the float64 engine to float32 tolerance; GT, GQ and filters agree except
within that tolerance of a decision boundary.

Selected with ``--genotyping-engine device``, or by ``auto`` for runs of
>= 4 samples and >= 8 events, on the batch and pipelined paths
(pipeline/grmpy.py, pipeline/parallel_grmpy.py).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .batched import model_from_parameters
from .genotype import Genotype


def _genotype_from_row(out, i, gts) -> Genotype:
    g = Genotype()
    if bool(out["no_reads"][i]):
        g.filters.add("NO_READS")
        return g
    g.gt = list(gts[int(out["best_gt"][i])])
    g.gl_name = [tuple(gv) for gv in gts]
    g.gl = [float(x) for x in out["gl"][i]]
    g.gq = int(out["gq"][i])
    g.num_reads = int(out["num_reads"][i])
    g.allele_fractions = [float(x) for x in out["allele_fractions"][i]]
    g.coverage_test_pvalue = float(out["coverage_test_pvalue"][i])
    if bool(out["gq_filter"][i]):
        g.filters.add("GQ")
    if bool(out["bp_depth"][i]):
        g.filters.add("BP_DEPTH")
    return g


def _model_signature(param) -> tuple:
    return (param.num_alleles, param.ploidy,
            tuple(param.allele_error_rates),
            param.other_allele_error_rate,
            tuple(param.het_haplotype_fractions),
            param.other_het_haplotype_fraction,
            tuple(sorted((tuple(k), v)
                         for k, v in param.genotype_fractions.items())),
            param.min_pass_gq)


def genotype_events_on_device(genotypers: List, device="cuda",
                              stats: Optional[dict] = None,
                              mesh=None) -> None:
    """Genotype every event in `genotypers` (GraphBreakpointGenotyper
    instances with alignments added and parameters set) through the
    float32 model over `mesh` (default: every card of `device`'s type,
    ``make_mesh``), installing the results back into each genotyper.
    Adds into `stats`, when given, the (sample x breakpoint) jobs
    (`gt_device_jobs`) and the seconds of the model's calls, inputs in
    and outputs out included (`gt_device_call_s`)."""
    import torch

    from .. import add_stats
    from .batched import batched_genotype_full

    def sharded_population_genotyping(mesh, counts, depth, rlen, dsd,
                                      poisson, model, min_pass_gq):
        # the copy runs on one device: the port's mesh split is left out
        out = batched_genotype_full(
            *(torch.as_tensor(x) for x in (counts, depth, rlen, dsd,
                                           poisson)),
            *(model[k] for k in ("gt_ploidy", "error_rates",
                                 "het_fractions", "log_priors")),
            min_pass_gq=min_pass_gq)
        return {k: v.cpu().numpy() for k, v in out.items()}

    n_shards = 1
    # (model signature) -> the group's param and its [(event_idx, job)]
    groups: Dict[tuple, dict] = {}
    for ei, gtr in enumerate(genotypers):
        for job in gtr.collect_jobs():
            is_male = job[4]
            param = (gtr.p_male_genotype_parameter if is_male
                     else gtr.p_genotype_parameter)
            key = _model_signature(param)
            grp = groups.setdefault(key, {"param": param, "jobs": []})
            grp["jobs"].append((ei, job))

    per_event: List[Dict[tuple, Genotype]] = [dict() for _ in genotypers]
    n_jobs, call_s = 0, 0.0
    for grp in groups.values():
        param = grp["param"]
        jobs = grp["jobs"]
        model = model_from_parameters(param, device)
        # pad rows to a multiple of the shard count (none on one device);
        # they hold depth 1, read length 100 and sd 1, and are never read
        n = len(jobs)
        n_pad = -(-n // n_shards) * n_shards
        counts = np.zeros((n_pad, param.num_alleles), np.int32)
        depth = np.ones(n_pad, np.float32)
        rlen = np.full(n_pad, 100.0, np.float32)
        dsd = np.ones(n_pad, np.float32)
        poisson = np.zeros(n_pad, bool)
        for k, (_, (_, _, bp, cnt, _)) in enumerate(jobs):
            counts[k] = cnt
            depth[k] = bp.read_depth
            rlen[k] = bp.read_length
            dsd[k] = bp.depth_sd
            poisson[k] = bp.use_poisson_depth
        t0 = time.perf_counter()
        out = sharded_population_genotyping(
            mesh, counts, depth, rlen, dsd, poisson, model,
            min_pass_gq=param.min_pass_gq)
        call_s += time.perf_counter() - t0
        for k, (ei, (samplename, bp_name, _, _, _)) in enumerate(jobs):
            per_event[ei][(samplename, bp_name)] = _genotype_from_row(
                out, k, model["gts"])
        n_jobs += n

    for gtr, results in zip(genotypers, per_event):
        gtr.install_genotypes(results)
    add_stats(stats, {"gt_device_jobs": n_jobs, "gt_device_call_s": call_s})
