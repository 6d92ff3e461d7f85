"""The CUDA graph-SW kernels on the card, against their plain versions:
the paired multi-event fill (K1, also sharded over a mesh of one card),
the read-table kernel that builds its inputs from staged bytes, the
single-graph fill (K3), the multi-event fill on expanded reads (K2) and
the ablation variants of its column loop (K4).

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


TABLE_FIELDS = ("tile_col_start", "tile_col_len", "tile_event",
                "base_codes_t", "base_lens", "base_vlens", "col_idx", "flip",
                "comp")


def _table_case(name):
    """A case of CASES, or one of the table kernel's own: lower-case
    bases, reads past 832 bases, a dispatch without reads."""
    if name in CASES:
        return _case(**CASES[name])
    rng = random.Random(29)
    graphs, rpp = _case(seed=29, n_frac=0.1)
    if name == "lower_case":
        return graphs, [[r.lower() if i % 2 else r for i, r in enumerate(rs)]
                        for rs in rpp]
    if name == "no_reads":
        return graphs, [[] for _ in rpp]
    rpp[0] = rpp[0] + ["".join(rng.choice("ACGTN") for _ in range(
        rng.randint(833, 1000))) for _ in range(3)]
    return graphs, rpp


def _forms(rpp, form):
    """Read-string lists, (upper-case blob, lens) tuples, or every other
    pair a tuple."""
    if form == "lists":
        return rpp
    return [msw.pair_norm(r) if form == "blobs" or j % 2 else r
            for j, r in enumerate(rpp)]


def _assert_tables_equal(got, want):
    for field in TABLE_FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        assert x.device == y.device, field
        assert x.dtype == y.dtype and x.shape == y.shape, (
            field, x.dtype, y.dtype, x.shape, y.shape)
        assert torch.equal(x, y), field
    assert got.l_ev == want.l_ev


def _kernel_tables(a, rpp, device):
    """(the table kernel's FillTables, the host tables on the card, the
    plain version's on the card) of one dispatch."""
    want = msw.tables_from_numpy(
        msw.build_pair_tables(a, rpp, msw.TILE_LANES), a, device)
    s = msw.stage_pair_tables(a, rpp, msw.TILE_LANES)
    before = msw.pair_tables_kernel.launches
    got = msw.pair_tables_kernel(msw.staging_tensor(s, pin=True), s,
                                 want.packed_cols, want.pred_tables)
    torch.cuda.synchronize()
    assert msw.pair_tables_kernel.launches == before + 1
    plain = msw.pair_tables_reference(msw.staging_tensor(s, pin=False), s,
                                      want.packed_cols, want.pred_tables)
    return got, want, plain


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["lists", "blobs", "mixed"])
@pytest.mark.parametrize("name", sorted(CASES) + [
    "long_reads", "lower_case", "no_reads"])
def test_table_kernel_matches_host_tables(name, form, cuda_device):
    """The table kernel's tensors == build_pair_tables + dispatch_tables
    on the card == its plain version on the card; K1 on them gives the
    same outputs."""
    graphs, rpp = _table_case(name)
    a, _ = _host_tables(graphs, [[] for _ in graphs])
    got, want, plain = _kernel_tables(a, _forms(rpp, form), cuda_device)
    _assert_tables_equal(got, want)
    _assert_tables_equal(plain, want)
    assert torch.equal(msw.paired_fill(got), msw.paired_fill(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_reads,dtype", [(32767, torch.int16),
                                           (32768, torch.int32)])
def test_table_kernel_col_idx_int16_int32_switch(n_reads, dtype,
                                                 cuda_device):
    graphs, _ = _case(seed=30, n_pairs=2)
    rng = np.random.RandomState(30)
    lens = rng.randint(6, 12, size=n_reads).astype(np.int32)
    blob = rng.choice(list(b"ACGTN"), size=int(lens.sum())).astype(
        np.uint8).tobytes()
    half = int(lens[:n_reads // 2].sum())
    rpp = [(blob[:half], lens[:n_reads // 2]), (blob[half:],
                                                lens[n_reads // 2:])]
    a, _ = _host_tables(graphs, [[] for _ in graphs])
    got, want, plain = _kernel_tables(a, rpp, cuda_device)
    assert got.col_idx.dtype == dtype
    _assert_tables_equal(got, want)
    _assert_tables_equal(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paired", "sharded"])
def test_tables_on_card_counts_every_dispatch(kind, cuda_device):
    graphs, rpp = _case(seed=27, n_pairs=5, n_reads=(1, 20))
    sw = _scorers(kind, [(graphs, rpp)], cuda_device)[0]
    before = msw.pair_tables_kernel.launches
    sw.score_pairs(rpp)
    sw.finalize_pairs(sw.score_pairs_device(rpp[::-1]))
    assert sw.stats["dispatches"] > 0
    assert sw.stats["tables_on_card"] == sw.stats["dispatches"] \
        == msw.pair_tables_kernel.launches - before


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
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_scorer_on_one_card_matches_single(name, cuda_device):
    """ShardedPairedSW over [cuda:0] * 3 (three shards on one card, one
    K1 launch per slot) against PairedGraphSW on the seeded cases."""
    from paragraph_tpu_torch.parallel.distributed import ShardedPairedSW

    graphs, rpp = _case(**CASES[name])
    sharded = ShardedPairedSW(graphs, [torch.device("cuda", 0)] * 3)
    before = msw.paired_fill.launches
    got = sharded.score_pairs(rpp)
    assert msw.paired_fill.launches - before == len(sharded.slot_pairs) \
        == sum(len(r) for r in sharded.rounds) >= min(3, len(graphs))
    want = msw.PairedGraphSW(graphs, device=cuda_device).score_pairs(rpp)
    for g, w in zip(got, want):
        for side in range(2):
            for x, y in zip(g[side], w[side]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_scorer_over_every_card(name, cuda_device):
    """ShardedPairedSW over the default mesh (every visible card, one
    shard each) against PairedGraphSW on the first card."""
    from paragraph_tpu_torch.parallel.distributed import (ShardedPairedSW,
                                                          make_event_mesh)

    graphs, rpp = _case(**CASES[name])
    mesh = make_event_mesh("cuda")
    assert mesh == [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    sharded = ShardedPairedSW(graphs, mesh)
    devices = {str(packed.device) for packed, _ in sharded._chunk_dev}
    assert devices == {str(d) for d in mesh[:len(sharded.slot_pairs)]}
    got = sharded.score_pairs(rpp)
    want = msw.PairedGraphSW(graphs, device=cuda_device).score_pairs(rpp)
    for g, w in zip(got, want):
        for side in range(2):
            for x, y in zip(g[side], w[side]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_pipeline_over_every_card(cuda_device, tmp_path):
    """graft_entry.dryrun_multichip over every visible card (distinct
    cards; one on a one-card host) on an 8-event, 2-sample workload at
    10x: the sharded pipelined run == the serial run, the merged edge
    counts, and the device engine's confident calls; and
    merged_edge_counts sums on the first card."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
    from make_workload import generate

    from paragraph_tpu_torch.graft_entry import dryrun_multichip
    from paragraph_tpu_torch.parallel.mesh import merged_edge_counts

    n = torch.cuda.device_count()
    generate(str(tmp_path), n_events=8, depth=10, seed=17, n_samples=2)
    before = msw.paired_fill.launches
    summary = dryrun_multichip(n, str(tmp_path))
    assert summary["events"] == max(8, 2 * n)
    assert msw.paired_fill.launches > before
    support = np.random.default_rng(1).integers(0, 2, (8 * n, 5))
    merged = merged_edge_counts([torch.device("cuda", i) for i in range(n)],
                                support.astype(np.int32))
    assert merged.device == torch.device("cuda", 0)
    np.testing.assert_array_equal(merged.cpu().numpy(), support.sum(0))


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


def _short_graph_long_reads(M, seed, n_cols=200):
    """A graph of four nodes and ~n_cols columns (the paired fills' packed
    end-cell word takes M = 2048 only over <= 256 columns per event) and
    reads of mixed lengths: 20 to 150 bases, and 833 to M bases holding a
    stretch of the graph's path between random flanks, one of exactly M
    and two whose stretch ends on rows 831 and 832."""
    rng = random.Random(seed)
    seqs = [_seq(rng, n_cols // 4) for _ in range(4)]
    g = SequenceGraph([f"n{i}" for i in range(4)], seqs)
    for f, t in [(0, 1), (0, 2), (1, 2), (2, 3), (1, 3)]:
        g.add_edge(f, t)
    path = "".join(seqs)
    reads = [path[k:k + rng.randint(20, 150)] for k in range(0, 120, 20)]
    for end in (832, 833):
        reads.append(_seq(rng, end - len(path)) + path
                     + _seq(rng, rng.randint(0, M - end)))
    for n in [M] + [rng.randint(833, M) for _ in range(5)]:
        k = rng.randint(20, len(path))
        pre = rng.randint(0, n - k)
        reads.append(_seq(rng, pre) + path[:k] + _seq(rng, n - pre - k))
    return g, reads


@pytest.mark.cuda
@pytest.mark.parametrize("M", [833, 864, 1024, 1500, 2048])
def test_kernels_on_long_reads(M, cuda_device):
    """Past 832 rows the three kernels run in row bands: each equals its
    plain fill on reads of mixed lengths in one launch. K3 on a graph of
    ~5 M / 3 columns and on a short one; K1 and K2 on the short one, where
    their packed end-cell word holds the scores."""
    g, reads = _long_case(M, seed=M)
    reads = reads + [r[:40] for r in reads]
    codes, lens, vlens = encode_reads(reads, M)
    t3 = psw.graph_tables_from_numpy(GraphArrays.build(g), codes.T, lens,
                                     vlens, cuda_device)
    before = psw.graph_fill.launches
    assert torch.equal(psw.graph_fill(t3), psw.graph_fill_reference(t3))
    assert psw.graph_fill.launches == before + 1
    fills = _all_kernels_match(*_short_graph_long_reads(M, seed=M),
                               cuda_device, M)
    assert min(fills) > 832 and fills[0] == -(M // -16) * 16


@pytest.mark.cuda
def test_wrappers_refuse_more_rows_than_instantiated(cuda_device):
    """Past 832 rows K3 takes any M; K1 and K2 refuse exactly where the
    packed end-cell word of their plain fills (pack_bits) refuses: 2048
    rows over 512 columns per event."""
    from paragraph_tpu_torch.ops.batched_sw import pack_bits

    M = 2048
    g, reads = _short_graph_long_reads(M, seed=73, n_cols=400)
    codes, lens, vlens = encode_reads(reads, M)
    t3 = psw.graph_tables_from_numpy(GraphArrays.build(g), codes.T, lens,
                                     vlens, cuda_device)
    assert torch.equal(psw.graph_fill(t3), psw.graph_fill_reference(t3))
    # build_pair_tables refuses these tables itself; a 200-column graph's
    # tables, told 512 columns per event, reach the wrappers
    with pytest.raises(ValueError, match="packed end-cell word"):
        _host_tables([g], [reads])
    g, reads = _short_graph_long_reads(M, seed=73)
    a, t = _host_tables([g], [reads])
    assert t["l_ev"] == 256 and t["m"] == M
    assert pack_bits(256, M, 1) is not None and pack_bits(512, M, 1) is None
    t1 = msw.tables_from_numpy(t, a, cuda_device)
    t2, _ = msw.MultiGraphSW([g], device=cuda_device).tables(0, [reads])
    before = (msw.paired_fill.launches, msw.multi_fill.launches)
    for fill, plain, tables in ((msw.paired_fill, msw.paired_fill_reference,
                                 t1),
                                (msw.multi_fill, msw.multi_fill_reference,
                                 t2)):
        wide = dataclasses.replace(tables, l_ev=512)
        for f in (fill, plain):
            with pytest.raises(ValueError, match="packed end-cell word"):
                f(wide)
    assert before == (msw.paired_fill.launches, msw.multi_fill.launches)
    for fill, plain, tables in ((msw.paired_fill, msw.paired_fill_reference,
                                 t1),
                                (msw.multi_fill, msw.multi_fill_reference,
                                 t2)):
        assert torch.equal(fill(tables), plain(tables))


@pytest.mark.cuda
def test_device_engine_on_cuda_matches_cpu(cuda_device):
    """The float32 genotyping engine (genotyping/batched.py) on the card
    against itself on the CPU: gl within 1e-5 relative; the integer
    outputs equal, but best_gt where the top two gl are within 1e-3 and GQ
    where its error probability is under 8 float32 ulps of the best gl
    (tests/test_torch_device_engine.py)."""
    from paragraph_tpu_torch.genotyping import batched
    from paragraph_tpu_torch.genotyping.parameters import (
        GenotypingParameters)

    rng = np.random.default_rng(3)
    n = 4096
    param = GenotypingParameters(["REF", "ALT", "ALT2"], 2)
    depth = rng.choice([10.0, 30.0, 60.0], n).astype(np.float32)
    inputs = (rng.poisson(depth[:, None] * rng.uniform(0, 0.6, (n, 3)))
              .astype(np.int32), depth,
              rng.choice([100.0, 150.0], n).astype(np.float32),
              np.sqrt(5 * depth).astype(np.float32), rng.random(n) < 0.5)
    outs = {}
    for dev in ("cpu", cuda_device):
        model = batched.model_from_parameters(param, dev)
        out = batched.batched_genotype_full(
            *(torch.as_tensor(x).to(dev) for x in inputs),
            model["gt_ploidy"], model["error_rates"], model["het_fractions"],
            model["log_priors"])
        outs[str(dev)] = {k: v.cpu().numpy() for k, v in out.items()}
    got, want = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(got["gl"], want["gl"], rtol=1e-5, atol=1e-6)
    gl = np.sort(want["gl"].astype(np.float64), -1)
    tie = gl[:, -1] - gl[:, -2] < 1e-3
    pr_err = -np.expm1(-np.log(np.exp(gl - gl[:, -1:]).sum(-1)))
    unresolved = pr_err <= 8 * np.spacing(np.abs(gl[:, -1]).astype(np.float32))
    for k, allowed in (("best_gt", tie), ("gq", tie | unresolved)):
        assert not ((got[k] != want[k]) & ~allowed).any(), k
    for k in ("num_reads", "no_reads", "gq_filter", "bp_depth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


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


@pytest.mark.cuda
def test_multiparagraph_on_cuda_matches_cpu(cuda_device, tmp_path):
    """The multiparagraph tool on a 4-event workload (two deletions, two
    insertions, 10x): on cuda (the single-graph kernel, launched) and on
    cpu (its plain fill) the JSON is the same apart from the engine
    marker."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
    from make_workload import generate
    from test_torch_tools import multiparagraph_events

    from paragraph_tpu_torch.cli.main import main

    truth = generate(str(tmp_path), n_events=4, depth=10, seed=7,
                     kinds=("DEL", "INS"))
    events = tmp_path / "events.json"
    events.write_text(json.dumps(multiparagraph_events(truth)))
    outs = {}
    for device in ("cuda", "cpu"):
        before = psw.graph_fill.launches
        out = tmp_path / f"{device}.json"
        assert main(["multiparagraph", str(events), "-b",
                     str(tmp_path / "sample.bam"), "-r",
                     str(tmp_path / "ref.fa"), "-o", str(out), "--device",
                     device]) == 0
        launched = psw.graph_fill.launches - before
        assert (launched > 0) == (device == "cuda"), (device, launched)
        outs[device] = json.loads(out.read_text())
    engines = [{e["graph"]["alignment_statistics"].pop("engine")
                for e in outs[d]} for d in ("cuda", "cpu")]
    assert engines == [{"cuda"}, {"torch"}]
    assert len(outs["cuda"]) == 4
    assert json.dumps(outs["cuda"], sort_keys=True) == json.dumps(
        outs["cpu"], sort_keys=True)


@pytest.mark.cuda
def test_bench_device_on_the_card(cuda_device):
    """tools/bench.py's bench_device on the card at 256 reads: the JAX
    bench's cell count (reads x 2 x both directions' columns x 160 rows),
    a positive rate and 1 + 2 x DEPTH paired launches; then a worker run
    on the CPU (in this process), or with no card visible, is refused
    for the card."""
    import contextlib
    import io
    import os
    import subprocess
    import sys

    from paragraph_tpu_torch.tools import bench

    g, reads = bench.build_case(n_reads=256)
    sw = msw.PairedGraphSW([g], device="cpu")   # the graph's arrays
    a = sw.chunk_arrays[0]
    want = 256 * 2 * (a.col_len[0] + a.col_len[1]) * 160
    assert bench.paired_cells(sw, reads) == want
    before = msw.paired_fill.launches
    rate, secs = bench.bench_device(g, reads, repeats=2, device=cuda_device)
    assert msw.paired_fill.launches - before == 1 + 2 * bench.DEPTH
    assert rate > 0 and rate * secs == pytest.approx(want, rel=1e-9)

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert bench.device_worker("cpu", n_reads=16) == 0
    result, why = bench.parse_worker(out.getvalue(), err.getvalue(), 0,
                                     "cuda")
    assert result is None and "platform cpu" in why
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hidden = subprocess.run(
        [sys.executable, "-m", "paragraph_tpu_torch.tools.bench",
         "--device-worker", "--device", "cuda"], cwd=root,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    result, why = bench.parse_worker(hidden.stdout, hidden.stderr,
                                     hidden.returncode, "cuda")
    assert hidden.returncode != 0 and result is None
    assert "torch.cuda.is_available() is false" in why


def _scorers(kind, cases, device):
    from paragraph_tpu_torch.parallel.distributed import ShardedPairedSW

    if kind == "paired":
        return [msw.PairedGraphSW(g, device=device) for g, _ in cases]
    return [ShardedPairedSW(g, [torch.device("cuda", 0)] * 4)
            for g, _ in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paired", "sharded"])
def test_rounds_finalised_behind_the_next_dispatch(kind, cuda_device):
    """Three rounds, each finalised after the next one is dispatched (two
    handles in flight, as the benchmark's realign loop and the pipeline
    run them): the outputs equal score_pairs one round at a time on the card
    and the plain fill's."""
    cases = [_case(seed=s, n_pairs=5, n_reads=(1, 20)) for s in (31, 32, 33)]
    scorers = _scorers(kind, cases, cuda_device)
    got = []
    pending = scorers[0].score_pairs_device(cases[0][1])
    for k in (1, 2):
        handle = scorers[k].score_pairs_device(cases[k][1])
        got.append(scorers[k - 1].finalize_pairs(pending))
        pending = handle
    got.append(scorers[2].finalize_pairs(pending))
    for (graphs, rpp), sw, g_round in zip(cases, scorers, got):
        one = sw.score_pairs(rpp)
        plain = msw.PairedGraphSW(graphs, device="cpu").score_pairs(rpp)
        for g, o, p in zip(g_round, one, plain):
            for side in range(2):
                for x, y, z in zip(g[side], o[side], p[side]):
                    assert x.dtype == y.dtype == z.dtype
                    np.testing.assert_array_equal(x, y)
                    np.testing.assert_array_equal(x, z)


def _large_dispatch(n_reads=3000, flank=4000, seed=41):
    """One pair whose K1 takes tens of ms: a deletion graph with 4 kb
    flanks and 150-base reads drawn from its reference path."""
    rng = random.Random(seed)
    left, alt, right = _seq(rng, flank), _seq(rng, 50), _seq(rng, flank)
    g = SequenceGraph(["left", "alt", "right"], [left, alt, right])
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(0, 2)
    ref = left + alt + right
    starts = [rng.randrange(len(ref) - 150) for _ in range(n_reads)]
    return [g], [[ref[s:s + 150] for s in starts]]


@pytest.mark.cuda
def test_fetch_waits_for_its_own_copy_out_only(cuda_device):
    """A small dispatch k, then a large one k+1: finalize_pairs(k) returns
    while the stream still runs K1(k+1), since k's copy-out was queued
    behind K1(k) and not behind K1(k+1). A fetch after a synchronize
    counts in fetch_ready."""
    small_g, small_rpp = _case(seed=34)
    small = msw.PairedGraphSW(small_g, device=cuda_device)
    large_g, large_rpp = _large_dispatch()
    large = msw.PairedGraphSW(large_g, device=cuda_device)
    large.score_pairs(large_rpp)  # the kernel library and the pinned pool
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    h_small = small.score_pairs_device(small_rpp)
    h_large = large.score_pairs_device(large_rpp)
    got = small.finalize_pairs(h_small)
    assert not stream.query()
    large.finalize_pairs(h_large)
    assert stream.query()
    want = msw.PairedGraphSW(small_g, device="cpu").score_pairs(small_rpp)
    for g, w in zip(got, want):
        for side in range(2):
            for x, y in zip(g[side], w[side]):
                np.testing.assert_array_equal(x, y)

    before = small.stats["fetch_ready"]
    handle = small.score_pairs_device(small_rpp)
    torch.cuda.synchronize()
    small.finalize_pairs(handle)
    assert small.stats["fetch_ready"] == before + len(small.chunk_pairs)
