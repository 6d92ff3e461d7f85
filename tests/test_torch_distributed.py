"""The port's sharding over a mesh against the JAX package's.

A mesh in the port is a list of torch devices, and a device may repeat,
so ``[cpu] * 8`` stands here for the JAX tests' 8-device CPU mesh
(tests/conftest.py). On the same seeded inputs:

- ``ShardedPairedSW`` on ``[cpu] * 8`` equals the JAX ShardedPairedSW on
  its 8-device mesh (interpret mode) and the port's ``PairedGraphSW``,
  bit for bit (the cases of tests/test_distributed.py);
- more slots than shards make several rounds, as in the JAX scorer;
- ``merged_edge_counts`` equals the JAX psum exactly;
- ``sharded_population_genotyping`` on ``[cpu] * 3`` (rows pad) agrees
  with the JAX function on its 8-device mesh within the float32
  tolerances of tests/test_torch_device_engine.py (gl within rtol 1e-5,
  atol 1e-4, tighter than tests/test_population_genotyping.py's 2e-4 /
  5e-3; decisions equal except at a decision boundary);
- ``run_grmpy`` over ``[cpu] * 4`` on the batch path (a make_workload
  run of 8 events at 10x, one sample) equals the port's one-device run
  and the JAX package's run, whose batch path shards over its 8 devices,
  apart from the engine marker (the pipelined path, with two samples:
  tests/test_torch_sharded_pipeline.py).
"""
import copy
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from paragraph_tpu.ops.multi_sw import PairedGraphSW as JaxPairedSW
from paragraph_tpu.parallel import distributed as jax_distributed
from paragraph_tpu.parallel import mesh as jax_mesh
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.parallel.distributed import (ShardedPairedSW,
                                                      make_event_mesh)
from paragraph_tpu_torch.parallel.mesh import (make_mesh, merged_edge_counts,
                                               sharded_population_genotyping)

from test_gssw_vs_reference import _random_graph, _read_from_graph
from test_torch_device_engine import (GL_ATOL, GL_RTOL, _batch,
                                      _differ_only_where, _gq_resolved,
                                      _jax_model, _near_boundary)
from torch_twins import jax_graphs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

CPU = torch.device("cpu")
FIELDS = ("score", "end_node", "end_ref", "end_read", "multi")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_graph(seqs, edges):
    g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    return g


def _assert_same(got, want, n_pairs):
    for k in range(n_pairs):
        for side in range(2):
            for name, a, b in zip(FIELDS, got[k][side], want[k][side]):
                assert np.array_equal(a, b), (k, side, name)


def test_meshes_on_the_cpu():
    """The CPU is one device; n_devices cuts the list; a repeated device
    is a mesh of several shards."""
    assert make_mesh("cpu") == [CPU]
    assert make_event_mesh("cpu") == [CPU]
    assert make_mesh("cpu", 0) == []
    sw = ShardedPairedSW([_make_graph(["ACGT"], [])], ["cpu"] * 3)
    assert sw.mesh == [CPU] * 3 and sw.n_shards == 3


@pytest.mark.parametrize("n_pairs", [3, 9, 17])
def test_sharded_matches_jax_and_single_device(n_pairs):
    """tests/test_distributed.py's seeded cases."""
    rng = random.Random(1000 + n_pairs)
    graphs = []
    reads_per_pair = []
    for _ in range(n_pairs):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=18)
        graphs.append(_make_graph(seqs, edges))
        reads = []
        for _ in range(rng.randint(0, 5)):
            r = _read_from_graph(rng, seqs, edges,
                                 read_len=rng.randint(6, 24))
            if r:
                reads.append(r)
        reads_per_pair.append(reads)

    sharded = ShardedPairedSW(graphs, mesh=[CPU] * 8)
    assert len(sharded.slot_pairs) >= min(8, n_pairs)
    assert sorted(p for s in sharded.slot_pairs for p in s) == \
        list(range(n_pairs))
    got = sharded.score_pairs(reads_per_pair)
    assert sharded.stats["dispatches"] == len(sharded.slot_pairs)
    _assert_same(got, msw.PairedGraphSW(graphs, device="cpu").score_pairs(
        reads_per_pair), n_pairs)
    twins = jax_graphs(graphs)
    jax_sharded = jax_distributed.ShardedPairedSW(
        twins, mesh=jax_distributed.make_event_mesh(8), interpret=True)
    assert sharded.slot_pairs == jax_sharded.slot_pairs
    _assert_same(got, jax_sharded.score_pairs(reads_per_pair), n_pairs)


def test_sharded_multi_round():
    """More slots than shards make several rounds: one pair per slot
    (col_budget=1) on a 2-entry mesh gives 3 rounds, as in the JAX
    scorer, and one launch per slot."""
    rng = random.Random(77)
    graphs = []
    reads_per_pair = []
    for _ in range(5):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=16)
        graphs.append(_make_graph(seqs, edges))
        r = _read_from_graph(rng, seqs, edges, read_len=12)
        reads_per_pair.append([r] if r else ["ACGTACGTACGT"])
    sharded = ShardedPairedSW(graphs, mesh=[CPU] * 2, col_budget=1)
    assert len(sharded.rounds) == 3
    assert sharded.rounds == [[0, 1], [2, 3], [4]]
    jax_sharded = jax_distributed.ShardedPairedSW(
        jax_graphs(graphs), mesh=jax_distributed.make_event_mesh(2),
        interpret=True, col_budget=1)
    assert sharded.rounds == jax_sharded.rounds
    got = sharded.score_pairs(reads_per_pair)
    assert sharded.engine_report()["dispatches"] == 5
    _assert_same(got, msw.PairedGraphSW(graphs, device="cpu").score_pairs(
        reads_per_pair), 5)
    want = JaxPairedSW(jax_graphs(graphs), interpret=True).score_pairs(
        reads_per_pair)
    _assert_same(got, want, 5)


def test_merged_edge_counts_matches_jax():
    rng = np.random.default_rng(5)
    support = (rng.random((64, 7)) < 0.3).astype(np.int32)
    got = merged_edge_counts([CPU] * 8, support)
    want = np.asarray(jax_mesh.merged_edge_counts(jax_mesh.make_mesh(8),
                                                  support))
    assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        merged_edge_counts([CPU] * 3, support[:63]).numpy(),
        support[:63].sum(0))
    with pytest.raises(ValueError, match="do not split"):
        merged_edge_counts([CPU] * 3, support)


def _padded(arrays, n_pad):
    """The device engine's padding: rows of depth 1, read length 100 and
    sd 1 up to n_pad."""
    counts, depth, rlen, dsd, poisson = arrays
    n = len(depth)
    fill = (0, 1.0, 100.0, 1.0, False)
    out = []
    for x, v in zip((counts, depth, rlen, dsd, poisson), fill):
        pad = np.full((n_pad - n,) + x.shape[1:], v, x.dtype)
        out.append(np.concatenate([x, pad]))
    return out


@pytest.mark.parametrize("n_alleles,ploidy,poisson",
                         [(2, 2, False), (3, 2, None)])
def test_sharded_population_genotyping_matches_jax(n_alleles, ploidy,
                                                   poisson):
    from paragraph_tpu_torch.genotyping import batched

    param, *arrays = _batch(19 * n_alleles + ploidy, n_alleles, ploidy,
                            poisson)
    n = len(arrays[1]) - 6  # 250 rows: pad rows on both meshes
    arrays = [x[:n] for x in arrays]
    model = batched.model_from_parameters(param, "cpu")
    out = sharded_population_genotyping([CPU] * 3, *_padded(arrays, 252),
                                        model)
    jm = _jax_model(param)
    want = jax_mesh.sharded_population_genotyping(
        jax_mesh.make_mesh(8), *_padded(arrays, 256), jm)
    out = {k: v[:n] for k, v in out.items()}
    want = {k: np.asarray(v)[:n] for k, v in want.items()}
    assert set(out) == set(want)
    np.testing.assert_allclose(out["gl"], want["gl"], rtol=GL_RTOL,
                               atol=GL_ATOL)
    np.testing.assert_array_equal(out["num_reads"], want["num_reads"])
    np.testing.assert_array_equal(out["no_reads"], want["no_reads"])
    free = ~_near_boundary(want["gl"], want["coverage_test_pvalue"])
    for k in ("best_gt", "gq_filter", "bp_depth"):
        _differ_only_where(out[k], want[k], ~free, k)
    _differ_only_where(out["gq"], want["gq"],
                       ~(free & _gq_resolved(want["gl"])), "gq")
    one = sharded_population_genotyping([CPU], *arrays, model)
    np.testing.assert_allclose(out["gl"], one["gl"], rtol=GL_RTOL,
                               atol=GL_ATOL)
    with pytest.raises(ValueError, match="do not split"):
        sharded_population_genotyping([CPU] * 3, *arrays[:5], model)


def _strip_engine(obj):
    if isinstance(obj, dict):
        return {k: _strip_engine(v) for k, v in obj.items()
                if k != "engine"}
    if isinstance(obj, list):
        return [_strip_engine(v) for v in obj]
    return obj


def _same(a, b):
    return json.dumps(_strip_engine(a), sort_keys=True) == json.dumps(
        _strip_engine(json.loads(json.dumps(b))), sort_keys=True)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """(graph descriptions, reference, manifest path) of an 8-event,
    2-sample make_workload run at 10x."""
    from make_workload import generate

    from paragraph_tpu_torch.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)

    wl = str(tmp_path_factory.mktemp("wl_sharded"))
    generate(wl, n_events=8, depth=10, seed=5, n_samples=2)
    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"), output=wl,
        split_type="superloci")
    graphs = load_graph_description(opts)
    assert len(graphs) == 8
    return graphs, opts.reference, opts.manifest


def _port(workload, n_samples, threads, mesh, stats=None):
    from paragraph_tpu_torch.genotyping.sample_info import load_manifest
    from paragraph_tpu_torch.pipeline.grmpy import GrmpyParameters, run_grmpy

    graphs, ref, manifest = workload
    return run_grmpy(copy.deepcopy(graphs), ref,
                     load_manifest(manifest)[:n_samples], None,
                     GrmpyParameters(threads=threads), batch_events=True,
                     device="cpu", kernel_stats=stats, mesh=mesh)


def _jax(workload, n_samples):
    """The JAX package's batch path, sharded over its 8 devices."""
    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.pipeline.grmpy import GrmpyParameters, run_grmpy

    graphs, ref, manifest = workload
    return run_grmpy(copy.deepcopy(graphs), ref,
                     load_manifest(manifest)[:n_samples], None,
                     GrmpyParameters(threads=1), batch_events=True)


def test_batch_path_sharded_matches(workload):
    """threads=1 takes the batch path: one ShardedPairedSW over the 8
    pairs, one launch per shard."""
    stats = {}
    sharded = _port(workload, 1, 1, [CPU] * 4, stats)
    assert stats["dispatches"] == 4
    assert len(sharded) == 8
    single = {}
    assert _same(sharded, _port(workload, 1, 1, None, single))
    assert single["dispatches"] == 1
    assert _same(sharded, _jax(workload, 1))
