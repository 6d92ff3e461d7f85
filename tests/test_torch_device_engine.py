"""The port's float32 genotyping engine against the JAX package's.

genotyping/batched.py, parallel/mesh.py::sharded_population_genotyping and
genotyping/device_engine.py of the port run on the CPU here, on the same
seeded numpy inputs as the JAX package's counterparts (on JAX's CPU
backend) and the float64 engines. Both sides compute in float32 with
different libraries' lgamma, log, logsumexp, erfc and gammaincc, so:

- gl agrees within rtol 1e-5 and atol 1e-4 (a few float32 ulps of
  values up to ~1e3);
- the decisions (best GT, GQ, read count, the NO_READS / GQ / BP_DEPTH
  filters) are equal on every row, except that they may differ where
  JAX's top two gl are within 1e-3 of each other (the argmax can flip)
  or its depth-test p-value lies within 1e-6 relative of a cutoff (the
  filter can flip); each test prints how many rows differ;
- GQ may differ, besides, where GQ's error probability 1 - exp(best) /
  sum(exp) is under 8 float32 ulps of the best gl: there it is the
  rounding of logsumexp(gl) - best in float32 (for gl = -5.99 and a
  runner-up 15 below, 2.9e-7 against an ulp of 4.8e-7 gives GQ 100 on
  one side and 63 on the other), not a property of the model.

Against the float64 engine the JAX package's own tolerances hold
(tests/test_population_genotyping.py: rtol 2e-4, atol 5e-3, >= N-1 GT
matches).
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

from paragraph_tpu.genotyping import batched as jax_batched
from paragraph_tpu.genotyping import device_engine as jax_engine
from paragraph_tpu.genotyping.parameters import (
    GenotypingParameters as JaxParameters)
from paragraph_tpu.parallel.mesh import make_mesh
from paragraph_tpu_torch.genotyping import batched, device_engine
from paragraph_tpu_torch.genotyping.breakpoint_genotyper import (
    BreakpointGenotyper, BreakpointGenotyperParameter)
from paragraph_tpu_torch.genotyping.parameters import GenotypingParameters
from paragraph_tpu_torch.genotyping.vectorized import (
    VectorizedBreakpointGenotyper)
from paragraph_tpu_torch.parallel.mesh import sharded_population_genotyping

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

N = 256
GL_RTOL, GL_ATOL = 1e-5, 1e-4
GL_TIE = 1e-3
P_REL = 1e-6
CUTOFFS = (0.02, 0.0001)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n_alleles, ploidy, poisson):
    """Seeded inputs of N items: counts drawn around each genotype's
    expected depth, one row in eight with no reads, depths 10-60, read
    lengths 100 and 150."""
    rng = np.random.default_rng(seed)
    names = ["REF"] + [f"ALT{k}" for k in range(1, n_alleles)]
    param = GenotypingParameters(names, ploidy)
    gts = param.possible_genotypes
    depth = rng.choice([10.0, 30.0, 60.0], N).astype(np.float32)
    rlen = rng.choice([100.0, 150.0], N).astype(np.float32)
    lam = depth * (rlen - 16) / rlen
    counts = np.zeros((N, n_alleles), np.int32)
    for i in range(N):
        gv = gts[rng.integers(len(gts))]
        for al in range(n_alleles):
            copies = sum(1 for g in gv if g == al)
            m = lam[i] * (copies / ploidy if copies else 0.05)
            counts[i, al] = int(m * rng.uniform(0.6, 1.4))
    counts[::8] = 0
    dsd = np.sqrt(5 * depth).astype(np.float32)
    use_poisson = np.full(N, poisson) if poisson is not None else \
        rng.random(N) < 0.5
    return param, counts, depth, rlen, dsd, use_poisson


def _jax_model(param):
    return jax_batched.model_from_parameters(
        JaxParameters(param.allele_names, param.ploidy))


CASES = [(2, 2, False), (2, 2, True), (3, 2, False), (3, 2, None),
         (2, 1, True), (3, 1, False)]


def _near_boundary(gl, pv):
    """Rows where the decisions may flip between two float32
    implementations: JAX's top two gl within GL_TIE, or its two-sided
    p-value within P_REL relative of a cutoff."""
    top = np.sort(gl, axis=-1)
    tie = (top[:, -1] - top[:, -2]) < GL_TIE if gl.shape[1] > 1 else \
        np.zeros(len(gl), bool)
    near = np.zeros(len(gl), bool)
    for c in CUTOFFS:
        near |= np.abs(pv - c) <= P_REL * c
    return tie | near


def _differ_only_where(got, want, allowed, name):
    """Number of rows where got != want; raises if any lies outside
    `allowed`."""
    bad = np.asarray(got) != np.asarray(want)
    outside = np.nonzero(bad & ~allowed)[0]
    assert not len(outside), f"{name} differs at rows {outside[:8]}"
    return int(bad.sum())


def _gq_resolved(gl):
    """Rows whose GQ error probability (from JAX's gl, in float64)
    exceeds 8 float32 ulps of the best gl."""
    gl = np.asarray(gl, np.float64)
    best = gl.max(-1)
    pr_err = -np.expm1(best - np.log(np.exp(gl - best[:, None]).sum(-1))
                       - best)
    return pr_err > 8 * np.spacing(np.abs(best).astype(np.float32))


def _inputs(device, counts, depth, rlen, dsd, use_poisson):
    return (torch.as_tensor(counts, device=device),
            torch.as_tensor(depth, device=device),
            torch.as_tensor(rlen, device=device),
            torch.as_tensor(dsd, device=device),
            torch.as_tensor(use_poisson, device=device))


@pytest.mark.parametrize("n_alleles,ploidy,poisson", CASES)
def test_likelihoods_match_jax(n_alleles, ploidy, poisson):
    param, counts, depth, rlen, _, _ = _batch(11 * n_alleles + ploidy,
                                              n_alleles, ploidy, poisson)
    model = batched.model_from_parameters(param, "cpu")
    jm = _jax_model(param)
    c, d, r = (torch.as_tensor(x) for x in (counts, depth, rlen))
    gl, best, gq = batched.batched_genotype_likelihoods(
        c, d, r, model["gt_ploidy"], model["error_rates"],
        model["het_fractions"], model["log_priors"])
    jgl, jbest, jgq = (np.asarray(x) for x in
                       jax_batched.batched_genotype_likelihoods(
                           counts, depth, rlen, jm["gt_ploidy"],
                           jm["error_rates"], jm["het_fractions"],
                           jm["log_priors"]))
    assert gl.dtype == torch.float32 and gl.shape == jgl.shape
    np.testing.assert_allclose(gl.numpy(), jgl, rtol=GL_RTOL, atol=GL_ATOL)
    free = ~_near_boundary(jgl, np.full(N, 0.5))
    n_best = _differ_only_where(best.numpy(), jbest, ~free, "best_gt")
    resolved = _gq_resolved(jgl)
    np.testing.assert_allclose(gq.numpy()[resolved], jgq[resolved],
                               rtol=1e-4, atol=1e-3)
    n_gq = int((~np.isclose(gq.numpy(), jgq, rtol=1e-4, atol=1e-3)).sum())
    print(f"rows that differ: best_gt {n_best}, gq {n_gq} (of {N})")


@pytest.mark.parametrize("n_alleles,ploidy,poisson", CASES)
def test_full_step_matches_jax(n_alleles, ploidy, poisson):
    param, counts, depth, rlen, dsd, use_poisson = _batch(
        7 * n_alleles + ploidy, n_alleles, ploidy, poisson)
    model = batched.model_from_parameters(param, "cpu")
    out = batched.batched_genotype_full(
        *_inputs("cpu", counts, depth, rlen, dsd, use_poisson),
        model["gt_ploidy"], model["error_rates"], model["het_fractions"],
        model["log_priors"])
    out = {k: v.numpy() for k, v in out.items()}
    jm = _jax_model(param)
    want = {k: np.asarray(v) for k, v in jax_batched.batched_genotype_full(
        counts, depth, rlen, dsd, use_poisson, jm["gt_ploidy"],
        jm["error_rates"], jm["het_fractions"], jm["log_priors"]).items()}
    assert set(out) == set(want)
    for k in want:
        assert out[k].shape == want[k].shape, k
    assert out["gq"].dtype == np.int32 and out["num_reads"].dtype == np.int32
    assert out["gl"].dtype == np.float32
    np.testing.assert_allclose(out["gl"], want["gl"], rtol=GL_RTOL,
                               atol=GL_ATOL)
    np.testing.assert_allclose(out["allele_fractions"],
                               want["allele_fractions"], rtol=1e-6)
    np.testing.assert_allclose(out["coverage_test_pvalue"],
                               want["coverage_test_pvalue"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(out["num_reads"], want["num_reads"])
    np.testing.assert_array_equal(out["no_reads"], want["no_reads"])
    assert out["no_reads"].sum() >= N // 8
    free = ~_near_boundary(want["gl"], want["coverage_test_pvalue"])
    differ = {k: _differ_only_where(out[k], want[k], ~free, k)
              for k in ("best_gt", "gq_filter", "bp_depth")}
    differ["gq"] = _differ_only_where(
        out["gq"], want["gq"], ~(free & _gq_resolved(want["gl"])), "gq")
    print(f"rows that differ (of {N}): {differ}")


def test_population_step_matches_float64_engine():
    """sharded_population_genotyping on one device against the float64
    VectorizedBreakpointGenotyper, as tests/test_population_genotyping.py
    holds the JAX package's mesh version."""
    import random

    rng = random.Random(42)
    names = ["REF", "ALT"]
    param = GenotypingParameters(names, 2)
    oracle = VectorizedBreakpointGenotyper(param)
    model = batched.make_model_inputs(names, 2, device="cpu")
    b_params, counts = [], []
    for i in range(N):
        depth = rng.choice([10.0, 30.0, 60.0])
        lam = depth * (150 - 16) / 150
        gv = rng.choice(param.possible_genotypes)
        row = []
        for al in range(2):
            copies = sum(1 for g in gv if g == al)
            m = lam * (0.5 * copies if copies else 0.05)
            row.append(0 if i % 32 == 0 else int(m * rng.uniform(0.6, 1.4)))
        counts.append(row)
        b_params.append(BreakpointGenotyperParameter(
            depth, 150, math.sqrt(5 * depth), i % 2 == 1))
    out = sharded_population_genotyping(
        [torch.device("cpu")], counts, [p.read_depth for p in b_params],
        [p.read_length for p in b_params], [p.depth_sd for p in b_params],
        [p.use_poisson_depth for p in b_params], model)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    want = oracle.genotype_batch(b_params, np.asarray(counts))
    gts = model["gts"]
    n_gt_match = n_called = 0
    for i, w in enumerate(want):
        if "NO_READS" in w.filters:
            assert bool(out["no_reads"][i])
            continue
        n_called += 1
        n_gt_match += list(gts[int(out["best_gt"][i])]) == w.gt
        np.testing.assert_allclose(out["gl"][i], w.gl, rtol=2e-4, atol=5e-3)
        assert bool(out["bp_depth"][i]) == ("BP_DEPTH" in w.filters)
    assert n_called >= N - N // 32 - 1
    assert n_gt_match >= n_called - 1


def test_batched_genotyping_matches_scalar():
    """tests/test_genotyping.py's check, on the port: batched likelihoods
    agree with the scalar float64 parity engine."""
    alleles = ["REF", "ALT"]
    model = batched.make_model_inputs(alleles, device="cpu")
    scalar = BreakpointGenotyper(GenotypingParameters(alleles, 2))
    p = BreakpointGenotyperParameter(40.0, 100, 20.0, False)
    counts = np.array([[20, 0], [20, 20], [0, 20], [5, 9]], np.int32)
    gl, best, gq = batched.batched_genotype_likelihoods(
        torch.as_tensor(counts), torch.full((4,), 40.0),
        torch.full((4,), 100.0), model["gt_ploidy"], model["error_rates"],
        model["het_fractions"], model["log_priors"])
    for i in range(4):
        ref_gt = scalar.genotype(p, list(counts[i]))
        assert model["gts"][int(best[i])] == tuple(ref_gt.gt)
        for gi, gt in enumerate(model["gts"]):
            ref_gl = dict(zip(ref_gt.gl_name, ref_gt.gl))[gt]
            assert float(gl[i, gi]) == pytest.approx(ref_gl, rel=1e-4)


def _parameters(pair):
    """The same genotyping parameters as the port's and as the JAX
    package's GenotypingParameters."""
    names, ploidy, overrides = pair
    out = []
    for cls in (GenotypingParameters, JaxParameters):
        p = cls(names, ploidy)
        for k, v in overrides.items():
            setattr(p, k, v)
        out.append(p)
    return out


@pytest.mark.parametrize("pair", [
    (["REF", "ALT"], 2, {}),
    (["REF", "ALT", "ALT2"], 2, {"allele_error_rates": [0.01, 0.02, 0.03],
                                 "het_haplotype_fractions": [0.5, 0.4, 0.3],
                                 "genotype_fractions": {(0, 0): 0.5,
                                                        (0, 1): 0.25,
                                                        (1, 1): 0.0}}),
    (["REF", "ALT"], 1, {"other_allele_error_rate": 0.1,
                         "other_het_haplotype_fraction": 0.45}),
], ids=["default", "three_alleles_priors", "haploid"])
def test_model_tables_carry_over(pair):
    """The model tables are the engine's weights: the same
    GenotypingParameters give equal arrays on both sides."""
    ours, theirs = _parameters(pair)
    got = batched.model_from_parameters(ours, "cpu")
    want = jax_batched.model_from_parameters(theirs)
    assert got["gts"] == want["gts"]
    for k in ("gt_ploidy", "error_rates", "het_fractions", "log_priors"):
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_combined_consensus_fast_path():
    best = np.array([[2, 2, 2], [1, 2, 2], [0, 0, 0], [1, 1, 3]], np.int32)
    pass_mask = np.array([[1, 1, 1], [1, 1, 1], [0, 0, 0], [1, 1, 0]], bool)
    consensus, conflict = batched.combined_consensus_batch(
        torch.as_tensor(best), torch.as_tensor(pass_mask),
        torch.ones(4, 3, dtype=torch.bool))
    assert consensus.tolist() == [2, -1, -1, 1]
    assert conflict.tolist() == [False, True, False, False]


def test_combined_consensus_matches_jax_on_random_votes():
    rng = np.random.default_rng(5)
    best = rng.integers(0, 4, (64, 5)).astype(np.int32)
    pass_mask = rng.random((64, 5)) < 0.6
    has_gt = rng.random((64, 5)) < 0.9
    got = batched.combined_consensus_batch(
        torch.as_tensor(best), torch.as_tensor(pass_mask),
        torch.as_tensor(has_gt))
    want = jax_batched.combined_consensus_batch(best, pass_mask, has_gt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_genotype_tables_match_jax():
    for ploidy, a in ((1, 2), (2, 2), (2, 3), (3, 2)):
        got = batched.genotype_tables(ploidy, a)
        want = jax_batched.genotype_tables(ploidy, a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.fixture(scope="module")
def genotyper_pairs(tmp_path_factory):
    """The port's and the JAX package's GraphBreakpointGenotyper of every
    event of a small four-sample make_workload run, with the same
    alignments (the port's host path aligns; both count)."""
    import copy

    from make_workload import generate

    from paragraph_tpu.genotyping.sample_info import (
        load_manifest as jax_manifest)
    from paragraph_tpu.pipeline.grmpy import (
        make_event_genotyper as jax_genotyper)
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.pipeline.grmpy import (
        GrmpyParameters, align_samples_batched, make_event_genotyper)
    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    wl = str(tmp_path_factory.mktemp("wl_engine"))
    generate(wl, n_events=2, depth=10, seed=9, n_samples=4)
    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"), output=wl)
    graphs = load_graph_description(opts)
    jobs = align_samples_batched(
        GrmpyParameters(threads=1), graphs, opts.reference,
        load_manifest(opts.manifest), {}, device="cpu")
    by_graph = {}
    for gd, _, _, s, _ in jobs:
        by_graph.setdefault(id(gd), (gd, []))[1].append(s)
    ours, theirs = [], []
    jax_samples = {s.sample_name: s for s in jax_manifest(opts.manifest)}
    for gd, samples in by_graph.values():
        ours.append(make_event_genotyper(gd, opts.reference, None, samples))
        twins = []
        for s in samples:
            t = copy.copy(jax_samples[s.sample_name])
            t.alignment_data = copy.deepcopy(s.alignment_data)
            twins.append(t)
        theirs.append(jax_genotyper(copy.deepcopy(gd), opts.reference, None,
                                    twins))
    return ours, theirs


def test_device_engine_matches_jax(genotyper_pairs):
    ours, theirs = genotyper_pairs
    stats = {}
    device_engine.genotype_events_on_device(ours, "cpu", stats)
    assert stats["gt_device_jobs"] == sum(len(g.collect_jobs())
                                          for g in ours) > 0
    assert stats["gt_device_call_s"] > 0
    jax_engine.genotype_events_on_device(theirs, make_mesh(8))
    n_exempt = n_checked = n_gq = 0
    for a, b in zip(ours, theirs):
        assert set(a.genotypes) == set(b.genotypes)
        for key, want in b.genotypes.items():
            got = a.genotypes[key]
            if key[1] == "":  # the combined genotype, checked below
                continue
            if not want.gl:
                assert got.filters == want.filters == {"NO_READS"}, key
                continue
            np.testing.assert_allclose(got.gl, want.gl, rtol=GL_RTOL,
                                       atol=GL_ATOL)
            if _near_boundary(np.asarray([want.gl]),
                              np.asarray([want.coverage_test_pvalue]))[0]:
                n_exempt += 1
                continue
            n_checked += 1
            assert (got.gt, got.num_reads, got.filters) == \
                (want.gt, want.num_reads, want.filters), key
            if got.gq != want.gq:
                assert not _gq_resolved(np.asarray([want.gl]))[0], key
                n_gq += 1
    assert n_checked > 0
    if not n_exempt:
        for a, b in zip(ours, theirs):
            for s in a.sample_names:
                got, want = a.genotypes[(s, "")], b.genotypes[(s, "")]
                assert (got.gt, got.filters) == (want.gt, want.filters)
    print(f"jobs near a boundary: {n_exempt}; checked {n_checked}, of "
          f"which GQ differs under 8 ulps: {n_gq}")
