"""The port's paired graph-SW fill and scorer vs the JAX package.

paired_fill_reference (the plain PyTorch fill, the CPU engine and the
CUDA kernel's oracle) against the TPU kernel paired_pallas_fill run in
interpret mode on identical tables, and the port's PairedGraphSW
against the JAX PairedGraphSW and the scalar gssw oracle. All outputs
are integer DP results: equality is exact. The CUDA kernel itself is
compared with the plain fill on the card in tests/test_torch_cuda.py.
"""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paragraph_tpu.align.gssw import GraphSW
from paragraph_tpu.ops import multi_sw as jax_msw
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw

from test_gssw_vs_reference import _random_graph, _read_from_graph
from torch_twins import jax_graph, jax_graphs

FIELDS = ("score", "end_node", "end_ref", "end_read", "multi")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other
    (a plain-fill test that takes 8 s alone took 200 s beside another).
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


def _case(seed, n_pairs=3, max_nodes=5, max_len=20, n_reads=(1, 5),
          read_lens=(6, 25), n_frac=0.0, empty_every=0):
    rng = random.Random(seed)
    graphs, rpp = [], []
    for k in range(n_pairs):
        seqs, edges = _random_graph(rng, max_nodes=max_nodes,
                                    max_len=max_len)
        seqs = ["".join("N" if rng.random() < n_frac else c for c in s)
                for s in seqs]
        graphs.append(_make_graph(seqs, edges))
        if empty_every and k % empty_every == 0:
            rpp.append([])
            continue
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(*read_lens))
                 for _ in range(rng.randint(*n_reads))]
        rpp.append([r for r in reads if r])
    return graphs, rpp


FILL_CASES = {
    "random": dict(seed=11),
    "n_bases": dict(seed=12, n_frac=0.15),
    "empty_pairs": dict(seed=13, n_pairs=4, empty_every=2),
    "longer_than_graph": dict(seed=14, max_len=6, read_lens=(40, 70)),
    "pad_tiles": dict(seed=15, n_pairs=3, n_reads=(30, 70)),
}


def _jax_tables(graphs, rpp):
    pairs = []
    for g in graphs:
        pairs.extend([g, g.reversed()])
    a = jax_msw.MultiGraphArrays(jax_graphs(pairs))
    return a, jax_msw.build_pair_tables(a, rpp, 128)


def _jax_fill(a, t):
    out = jax_msw.paired_pallas_fill(
        jnp.asarray(a.packed_cols), jnp.asarray(a.pred_tables),
        *(jnp.asarray(t[k]) for k in (
            "tile_col_start", "tile_col_len", "tile_event", "codes_t",
            "lens", "vlens", "col_idx", "flip", "comp")),
        L=len(a.ref_codes), L_ev=t["l_ev"], N=a.n_max, P=a.p_max,
        M=t["m"], TB=128, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("col_idx_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_reference_fill_matches_pallas_kernel(name, col_idx_dtype):
    a, t = _jax_tables(*_case(**FILL_CASES[name]))
    t["col_idx"] = t["col_idx"].astype(col_idx_dtype)
    want = _jax_fill(a, t)
    tables = msw.tables_from_numpy(t, a, "cpu")
    got = msw.paired_fill_reference(tables)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_paired_fill_on_cpu_runs_the_plain_version():
    a, t = _jax_tables(*_case(seed=16))
    tables = msw.tables_from_numpy(t, a, "cpu")
    before = msw.paired_fill.launches
    got = msw.paired_fill(tables)
    assert msw.paired_fill.launches == before
    assert torch.equal(got, msw.paired_fill_reference(tables))


def _assert_pairs_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for side in range(2):
            for name, x, y in zip(FIELDS, g[side], w[side]):
                assert x.dtype == y.dtype, (k, side, name)
                np.testing.assert_array_equal(x, y, err_msg=f"{k} {name}")


def _legacy_cases():
    """The cases of tests/test_paired_sw.py and tests/test_multi_sw.py."""
    out = {}
    rng = random.Random(909)
    graphs, rpp = [], []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=20)
        graphs.append(_make_graph(seqs, edges))
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(6, 25))
                 for _ in range(4)]
        rpp.append([r for r in reads if r])
    out["paired_909"] = (graphs, rpp)
    rng = random.Random(910)
    graphs, rpp = [], []
    for _ in range(4):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=16)
        graphs.append(_make_graph(seqs, edges))
        r = _read_from_graph(rng, seqs, edges, read_len=10)
        rpp.append([r] if r else ["ACGTACGT"])
    out["paired_910"] = (graphs, rpp)
    rng = random.Random(808)
    graphs, rpp = [], []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=20)
        graphs.append(_make_graph(seqs, edges))
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(8, 25))
                 for _ in range(3)]
        rpp.append([r for r in reads if r])
    out["multi_808"] = (graphs, rpp)
    rs = np.random.RandomState(3)
    seq = lambda n: "".join("ACGT"[i] for i in rs.randint(0, 4, n))
    g = SequenceGraph(["a", "b", "c"], [seq(60), seq(30), seq(60)])
    for f, t in ((0, 1), (0, 2), (1, 2)):
        g.add_edge(f, t)
    out["engine_report"] = ([g], [[seq(40) for _ in range(5)]])
    return out


LEGACY = _legacy_cases()


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_scorer_matches_jax_scorer(name):
    graphs, rpp = LEGACY[name]
    want = jax_msw.PairedGraphSW(jax_graphs(graphs),
                                 interpret=True).score_pairs(rpp)
    got = msw.PairedGraphSW(graphs, device="cpu").score_pairs(rpp)
    _assert_pairs_equal(got, want)


def test_chunking_keeps_pairs_together():
    graphs, rpp = LEGACY["paired_910"]
    chunked = msw.PairedGraphSW(graphs, device="cpu", col_budget=1)
    assert len(chunked.chunk_pairs) == 4
    got = chunked.score_pairs(rpp)
    one = msw.PairedGraphSW(graphs, device="cpu")
    assert len(one.chunk_pairs) == 1
    _assert_pairs_equal(got, one.score_pairs(rpp))
    want = jax_msw.PairedGraphSW(jax_graphs(graphs), interpret=True,
                                 col_budget=1).score_pairs(rpp)
    _assert_pairs_equal(got, want)


def test_pair_budget_splits_chunks():
    graphs, rpp = _case(seed=17, n_pairs=msw.PAIR_BUDGET + 2, max_len=6,
                        n_reads=(1, 2), read_lens=(6, 8))
    sw = msw.PairedGraphSW(graphs, device="cpu")
    assert [len(c) for c in sw.chunk_pairs] == [msw.PAIR_BUDGET, 2]
    _assert_pairs_equal(
        sw.score_pairs(rpp),
        msw.PairedGraphSW(graphs, device="cpu",
                          col_budget=1).score_pairs(rpp))


def test_forward_reads_match_scalar_oracle():
    graphs, rpp = LEGACY["multi_808"]
    results = msw.PairedGraphSW(graphs, device="cpu").score_pairs(rpp)
    for g, reads, (f_out, _) in zip(graphs, rpp, results):
        score, end_node, end_ref, end_read, multi = f_out
        scalar = GraphSW(jax_graph(g))
        for i, read in enumerate(reads):
            fills, max_node, max_score = scalar.fill(read)
            f = fills[max_node]
            assert score[i] == max_score, read
            assert end_node[i] == max_node
            assert end_ref[i] == f.ref_end1
            assert end_read[i] == f.read_end1
            assert bool(multi[i]) == scalar.ends_at_multiple_nodes(
                fills, max_score)


def test_zero_score_reads_flag_multi():
    """A lane with score 0 counts every node slot (pad and unvisited
    ones included) as attaining it, so multi = 1: the TPU kernel's quirk,
    reproduced."""
    g = _make_graph(["AAAAAA", "AAAA", "AAAAA"], [(0, 1), (0, 2), (1, 2)])
    rpp = [["CCCCCC", "NNNN", "A", "CCAC"]]
    got = msw.PairedGraphSW([g], device="cpu").score_pairs(rpp)
    want = jax_msw.PairedGraphSW([jax_graph(g)],
                                 interpret=True).score_pairs(rpp)
    _assert_pairs_equal(got, want)
    f_out = got[0][0]
    assert (f_out[0][:2] == 0).all() and (f_out[4][:2] == 1).all()
    assert (f_out[2][:2] == -1).all() and (f_out[3][:2] == 0).all()


def test_stats_carry_the_orchestrator_keys():
    graphs, rpp = LEGACY["engine_report"]
    sw = msw.PairedGraphSW(graphs, device="cpu")
    sw.score_pairs(rpp)
    rep = sw.engine_report()
    for key in ("dispatches", "cells", "lanes", "device_wait_s",
                "dispatch_host_s", "tables_s", "put_s", "call_s",
                "cells_per_wait_s"):
        assert key in rep, key
    assert "vpu_util_est" not in rep
    assert rep["dispatches"] == 1
    a = sw.chunk_arrays[0]
    real = 2 * len(rpp[0]) * (a.col_len[0] + a.col_len[1]) * 48
    assert rep["cells"] >= real
    assert rep["lanes"] % msw.TILE_LANES == 0


def test_kernel_needs_cuda_device():
    a, t = _jax_tables(*_case(seed=18))
    tables = msw.tables_from_numpy(t, a, "cpu")
    meta = dataclasses.replace(
        tables, packed_cols=tables.packed_cols.to("meta"))
    with pytest.raises(ValueError):
        msw.paired_fill(meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            msw.tables_from_numpy(t, a, "cuda")
