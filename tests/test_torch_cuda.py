"""The CUDA paired graph-SW kernel on the card, against its plain version.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports no jax, so on a machine without it the tests run
with the conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The plain PyTorch fill is itself held to the JAX package's TPU kernel on
the CPU (tests/test_torch_paired_sw.py), so kernel == plain closes the
chain. All outputs are integer DP results: equality is exact.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw

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
