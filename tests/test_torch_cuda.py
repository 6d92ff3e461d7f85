"""The CUDA graph-SW kernels on the card, against their plain versions:
the paired multi-event fill (K1), the single-graph fill (K3) and the
multi-event fill on expanded reads (K2).

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports no jax, so on a machine without it the tests run
with the conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The plain PyTorch fills are themselves held to the JAX package's TPU
kernels on the CPU (tests/test_torch_paired_sw.py,
tests/test_torch_pallas_sw.py, tests/test_torch_multi_sw.py), so kernel
== plain closes the chain. All outputs are integer DP results: equality
is exact.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.ops import pallas_sw as psw
from paragraph_tpu_torch.ops.batched_sw import GraphArrays, encode_reads

from test_gssw_vs_reference import _random_graph, _read_from_graph

CASES = {
    "random": dict(seed=21),
    "n_bases": dict(seed=22, n_frac=0.15),
    "mixed_6_150": dict(seed=23, max_len=120, read_lens=(6, 150),
                        n_reads=(1, 40)),
    "empty_pairs": dict(seed=24, n_pairs=4, empty_every=2),
    "longer_than_graph": dict(seed=25, max_len=6, read_lens=(40, 150)),
    "pad_tiles": dict(seed=26, n_pairs=3, n_reads=(30, 70)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _case(seed, n_pairs=3, max_len=20, n_reads=(1, 6), read_lens=(6, 25),
          n_frac=0.0, empty_every=0):
    rng = random.Random(seed)
    graphs, rpp = [], []
    for k in range(n_pairs):
        seqs, edges = _random_graph(rng, max_nodes=6, max_len=max_len)
        seqs = ["".join("N" if rng.random() < n_frac else c for c in s)
                for s in seqs]
        g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
        for f, t in edges:
            g.add_edge(f, t)
        graphs.append(g)
        if empty_every and k % empty_every == 0:
            rpp.append([])
            continue
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(*read_lens))
                 for _ in range(rng.randint(*n_reads))]
        rpp.append([r for r in reads if r])
    return graphs, rpp


def _host_tables(graphs, rpp):
    pairs = []
    for g in graphs:
        pairs.extend([g, g.reversed()])
    a = msw.MultiGraphArrays(pairs)
    return a, msw.build_pair_tables(a, rpp, msw.TILE_LANES)


@pytest.mark.cuda
@pytest.mark.parametrize("col_idx_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_fill(name, col_idx_dtype, cuda_device):
    a, t = _host_tables(*_case(**CASES[name]))
    t["col_idx"] = t["col_idx"].astype(col_idx_dtype)
    tables = msw.tables_from_numpy(t, a, cuda_device)
    before = msw.paired_fill.launches
    got = msw.paired_fill(tables)
    torch.cuda.synchronize()
    assert msw.paired_fill.launches == before + 1
    want = msw.paired_fill_reference(tables)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    cpu = msw.paired_fill_reference(msw.tables_from_numpy(t, a, "cpu"))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_scorer_on_cuda_matches_cpu(cuda_device):
    graphs, rpp = _case(seed=27, n_pairs=5, n_reads=(1, 20))
    got = msw.PairedGraphSW(graphs, device=cuda_device).score_pairs(rpp)
    want = msw.PairedGraphSW(graphs, device="cpu",
                             col_budget=1).score_pairs(rpp)
    for g, w in zip(got, want):
        for side in range(2):
            for x, y in zip(g[side], w[side]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    a, t = _host_tables(*_case(seed=28))
    tables = msw.tables_from_numpy(t, a, cuda_device)
    bad = [
        dataclasses.replace(tables, packed_cols=tables.packed_cols.long()),
        dataclasses.replace(tables, col_idx=tables.col_idx.long()),
        dataclasses.replace(tables, base_codes_t=tables.base_codes_t.T),
        dataclasses.replace(tables, flip=tables.flip.cpu()),
        dataclasses.replace(tables, tile_col_len=tables.tile_col_len[:-1]),
    ]
    before = msw.paired_fill.launches
    for t_bad in bad:
        with pytest.raises(ValueError):
            msw.paired_fill(t_bad)
    assert msw.paired_fill.launches == before


# single-graph cases: (graph case kwargs, number of reads to take, match)
GRAPH_CASES = {
    "random": (dict(seed=31, n_pairs=1, n_reads=(40, 40)), 40, 1),
    "n_bases": (dict(seed=32, n_pairs=1, n_frac=0.15, n_reads=(33, 33)),
                33, 1),
    "mixed_6_150": (dict(seed=33, n_pairs=1, max_len=120, read_lens=(6, 150),
                         n_reads=(70, 70)), 70, 1),
    "longer_than_graph": (dict(seed=34, n_pairs=1, max_len=6,
                               read_lens=(40, 150), n_reads=(20, 20)), 20, 1),
    "single_read": (dict(seed=35, n_pairs=1, n_reads=(1, 1)), 1, 1),
    "overflows_packed_word": (dict(seed=36, n_pairs=1, max_len=8,
                                   n_reads=(9, 9)), 9, 100000),
}


def _graph_tables(name, device):
    kwargs, n, match = GRAPH_CASES[name]
    graphs, rpp = _case(**kwargs)
    reads = (rpp[0] * n)[:n]
    max_len = max(len(r) for r in reads)
    codes, lens, vlens = encode_reads(reads, -(max_len // -32) * 32)
    return psw.graph_tables_from_numpy(
        GraphArrays.build(graphs[0]), codes.T, lens, vlens, device), match


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_kernel_matches_plain_fill(name, cuda_device):
    tables, match = _graph_tables(name, cuda_device)
    before = psw.graph_fill.launches
    got = psw.graph_fill(tables, match=match)
    torch.cuda.synchronize()
    assert psw.graph_fill.launches == before + 1
    want = psw.graph_fill_reference(tables, match=match)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    cpu, _ = _graph_tables(name, "cpu")
    assert torch.equal(got.cpu(), psw.graph_fill_reference(cpu, match=match))


@pytest.mark.cuda
def test_single_graph_scorer_on_cuda_matches_cpu(cuda_device):
    graphs, rpp = _case(seed=37, n_pairs=1, n_reads=(50, 50),
                        read_lens=(6, 150), max_len=80)
    got = psw.SingleGraphSW(graphs[0], device=cuda_device).score(rpp[0])
    want = psw.SingleGraphSW(graphs[0], tile_batch=32,
                             device="cpu").score(rpp[0])
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("col_budget", [msw.MultiGraphSW.COL_BUDGET, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_kernel_matches_plain_fill(name, col_budget, cuda_device):
    graphs, rpe = _case(**CASES[name])
    before = msw.multi_fill.launches
    sw = msw.MultiGraphSW(graphs, device=cuda_device, col_budget=col_budget)
    got = sw.score(rpe)
    assert msw.multi_fill.launches == before + len(sw.chunk_events)
    want = msw.MultiGraphSW(graphs, device="cpu",
                            col_budget=col_budget).score(rpe)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    tables, _ = _graph_tables("random", cuda_device)
    bad = [
        dataclasses.replace(tables, ref_codes=tables.ref_codes.long()),
        dataclasses.replace(tables, read_codes_t=tables.read_codes_t.int()),
        dataclasses.replace(tables, read_codes_t=tables.read_codes_t.T),
        dataclasses.replace(tables, lens=tables.lens.cpu()),
        dataclasses.replace(tables, vlens=tables.vlens[:, :-1]),
    ]
    before = psw.graph_fill.launches
    for t_bad in bad:
        with pytest.raises(ValueError):
            psw.graph_fill(t_bad)
    assert psw.graph_fill.launches == before

    graphs, rpe = _case(seed=38)
    sw = msw.MultiGraphSW(graphs, device=cuda_device)
    a = sw.chunk_arrays[0]
    n = 32 * len(rpe)
    good = msw.MultiFillTables(
        *msw.graph_tensors(a, cuda_device),
        tile_col_start=torch.tensor(a.col_start, dtype=torch.int32,
                                    device=cuda_device),
        tile_col_len=torch.tensor(a.col_len, dtype=torch.int32,
                                  device=cuda_device),
        tile_event=torch.arange(len(rpe), dtype=torch.int32,
                                device=cuda_device),
        read_codes_t=torch.full((32, n), 5, dtype=torch.int8,
                                device=cuda_device),
        lens=torch.zeros((1, n), dtype=torch.int32, device=cuda_device),
        vlens=torch.zeros((1, n), dtype=torch.int32, device=cuda_device),
        l_ev=256)
    assert torch.equal(msw.multi_fill(good), msw.multi_fill_reference(good))
    bad = [
        dataclasses.replace(good, read_codes_t=good.read_codes_t.int()),
        dataclasses.replace(good, lens=good.lens.cpu()),
        dataclasses.replace(good, tile_event=good.tile_event[:-1]),
        dataclasses.replace(good, vlens=good.vlens[:, :-32]),
    ]
    before = msw.multi_fill.launches
    for t_bad in bad:
        with pytest.raises(ValueError):
            msw.multi_fill(t_bad)
    assert msw.multi_fill.launches == before
