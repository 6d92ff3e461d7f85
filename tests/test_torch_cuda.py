"""The CUDA graph-SW kernels on the card, against their plain versions:
the paired multi-event fill (K1), the single-graph fill (K3), the
multi-event fill on expanded reads (K2) and the ablation variants of its
column loop (K4).

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

from paragraph_tpu_torch.graph.model import SequenceGraph
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_ablation_kernel_matches_plain_fill(name, cuda_device):
    """Every K4 variant (tools/kbench2.py) against its plain fill on the
    multi-event tables of a case; the exact ones equal the multi kernel."""
    from paragraph_tpu_torch.tools import kbench2

    graphs, rpe = _case(**CASES[name])
    sw = msw.MultiGraphSW(graphs, device=cuda_device)
    tables, _ = sw.tables(0, [rpe[e] for e in sw.chunk_events[0]])
    k2 = msw.multi_fill(tables)
    for variant in kbench2.VARIANTS:
        before = kbench2.kbench_fill.launches
        got = kbench2.kbench_fill(tables, variant)
        assert kbench2.kbench_fill.launches == before + 1
        assert torch.equal(got, kbench2.kbench_fill_reference(tables,
                                                              variant))
        if variant in kbench2.EXACT:
            assert torch.equal(got, k2), variant


# the warp-per-lane kernels (graph_sw.cu, paired_sw.cu) take R rows per
# thread from a fixed set of instantiations (ops/csrc/sw_warp.cuh): M at
# each boundary between two of them, and up to the largest
ROW_BOUNDARY_MS = [32, 48, 256, 272, 320, 384, 512, 528, 640, 656, 736, 752,
                   800, 832]


def _seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _long_case(M, seed):
    """A graph of five nodes of ~M/3 bases and reads of M/2 to M bases
    drawn from it, with one read of exactly M bases. (The paired fills'
    packed end-cell word holds 800-row reads over up to 2048 columns.)"""
    rng = random.Random(seed)
    seqs = [_seq(rng, max(8, M // 3)) for _ in range(5)]
    edges = [(0, 1), (0, 2), (1, 2), (2, 3), (1, 3), (3, 4), (2, 4)]
    g = SequenceGraph([f"n{i}" for i in range(5)], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    reads = [_read_from_graph(rng, seqs, edges,
                              read_len=rng.randint(M // 2, M))[:M]
             for _ in range(9)]
    return g, [r for r in reads if r] + ["".join(seqs)[:M]]


def _many_nodes_case(seed, n=60, max_preds=6):
    """A graph of n short nodes, each with up to max_preds predecessors
    among the ten before it, and reads drawn from it."""
    rng = random.Random(seed)
    seqs = [_seq(rng, rng.randint(1, 12)) for _ in range(n)]
    edges = []
    for t in range(1, n):
        window = range(max(0, t - 10), t)
        k = min(len(window), rng.randint(1, max_preds))
        edges.extend((f, t) for f in sorted(rng.sample(window, k)))
    g = SequenceGraph([f"n{i}" for i in range(n)], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    reads = [_read_from_graph(rng, seqs, edges,
                              read_len=rng.randint(20, 150))
             for _ in range(60)]
    return g, [r for r in reads if r]


def _all_kernels_match(g, reads, device, M=None):
    """K3, K1 and K2 on one graph and its reads, each against its plain
    fill on the same CUDA tensors; M pads K3's read rows (and K2's, which
    round them up to a multiple of 32, as K1's do). Returns the three
    fills' M."""
    max_len = max(len(r) for r in reads)
    M3 = M or -(max_len // -32) * 32
    codes, lens, vlens = encode_reads(reads, M3)
    t3 = psw.graph_tables_from_numpy(GraphArrays.build(g), codes.T, lens,
                                     vlens, device)
    assert torch.equal(psw.graph_fill(t3), psw.graph_fill_reference(t3))

    a, t = _host_tables([g], [reads])
    t1 = msw.tables_from_numpy(t, a, device)
    assert torch.equal(msw.paired_fill(t1), msw.paired_fill_reference(t1))

    sw = msw.MultiGraphSW([g, g.reversed()], device=device)
    t2, _ = sw.tables(0, [reads, reads], pad_to=M3)
    assert torch.equal(msw.multi_fill(t2), msw.multi_fill_reference(t2))
    return (t3.read_codes_t.shape[0], t1.base_codes_t.shape[0],
            t2.read_codes_t.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("M", ROW_BOUNDARY_MS)
def test_kernels_at_row_count_boundaries(M, cuda_device):
    g, reads = _long_case(M, seed=M)
    assert _all_kernels_match(g, reads, cuda_device, M) == (
        M, -(M // -32) * 32, -(M // -32) * 32)


@pytest.mark.cuda
def test_kernels_on_many_nodes_and_predecessors(cuda_device):
    g, reads = _many_nodes_case(seed=71)
    assert GraphArrays.build(g).pred_table.shape[1] >= 4
    assert g.num_nodes == 60
    _all_kernels_match(g, reads, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", [1, 3, 5, 33, 130])
def test_graph_kernel_on_lane_counts_off_the_cta(n_lanes, cuda_device):
    """Lane counts that are not a multiple of the CTA's lanes, and one
    lane."""
    graphs, rpp = _case(seed=72, n_pairs=1, n_reads=(40, 40),
                        read_lens=(6, 150), max_len=80)
    reads = (rpp[0] * n_lanes)[:n_lanes]
    max_len = max(len(r) for r in reads)
    codes, lens, vlens = encode_reads(reads, -(max_len // -32) * 32)
    t = psw.graph_tables_from_numpy(GraphArrays.build(graphs[0]), codes.T,
                                    lens, vlens, cuda_device)
    assert torch.equal(psw.graph_fill(t), psw.graph_fill_reference(t))


@pytest.mark.cuda
def test_wrappers_refuse_more_rows_than_instantiated(cuda_device):
    M = 864  # past 26 rows x 32 threads
    g, reads = _long_case(M, seed=73)
    codes, lens, vlens = encode_reads(reads, M)
    t3 = psw.graph_tables_from_numpy(GraphArrays.build(g), codes.T, lens,
                                     vlens, cuda_device)
    a, t = _host_tables([g], [reads])
    t1 = msw.tables_from_numpy(t, a, cuda_device)
    t2, _ = msw.MultiGraphSW([g], device=cuda_device).tables(0, [reads])
    before = (psw.graph_fill.launches, msw.paired_fill.launches,
              msw.multi_fill.launches)
    for fill, tables in ((psw.graph_fill, t3), (msw.paired_fill, t1),
                         (msw.multi_fill, t2)):
        with pytest.raises(ValueError):
            fill(tables)
    assert before == (psw.graph_fill.launches, msw.paired_fill.launches,
                      msw.multi_fill.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("M", ROW_BOUNDARY_MS)
def test_ablation_kernel_at_row_count_boundaries(M, cuda_device):
    """Every K4 variant (ops/csrc/kbench_warp.cuh, one instantiation per
    row count) against its plain fill at each boundary between two row
    counts; the exact ones equal the multi kernel."""
    from paragraph_tpu_torch.tools import kbench2

    g, reads = _long_case(M, seed=M)
    sw = msw.MultiGraphSW([g, g.reversed()], device=cuda_device)
    tables, _ = sw.tables(0, [reads, reads], pad_to=M)
    assert tables.read_codes_t.shape[0] == -(M // -32) * 32
    k2 = msw.multi_fill(tables)
    before = kbench2.kbench_fill.launches
    outs = kbench2.check_variants(tables, kbench2.VARIANTS)
    assert kbench2.kbench_fill.launches == before + len(kbench2.VARIANTS)
    for variant, (got, want) in outs.items():
        assert torch.equal(got, want), variant
        if variant in kbench2.EXACT:
            assert torch.equal(got, k2), variant


@pytest.mark.cuda
def test_ablation_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device, monkeypatch):
    """More rows than the largest instantiation, gap_open < gap_extend,
    and an odd column count for the unroll variants: each raises before
    any launch."""
    from paragraph_tpu_torch.tools import kbench2

    g, reads = _long_case(864, seed=74)  # past 26 rows x 32 threads
    long_tables, _ = msw.MultiGraphSW([g], device=cuda_device).tables(
        0, [reads])
    graphs, rpe = _case(seed=75)
    sw = msw.MultiGraphSW(graphs, device=cuda_device)
    tables, _ = sw.tables(0, [rpe[e] for e in sw.chunk_events[0]])
    odd = dataclasses.replace(tables, tile_col_len=tables.tile_col_len - 1)
    before = kbench2.kbench_fill.launches
    for variant in kbench2.VARIANTS:
        with pytest.raises(ValueError):
            kbench2.kbench_fill(long_tables, variant)
    for variant in ("unroll2", "hoist_u2"):
        with pytest.raises(ValueError, match="multiple"):
            kbench2.kbench_fill(odd, variant)
    monkeypatch.setitem(kbench2.SCORING, "gap_open", 0)
    with pytest.raises(ValueError, match="gap_open"):
        kbench2.kbench_fill(tables, "v0")
    assert kbench2.kbench_fill.launches == before
    monkeypatch.undo()
    assert torch.equal(kbench2.kbench_fill(odd, "v0"),
                       kbench2.kbench_fill_reference(odd, "v0"))
