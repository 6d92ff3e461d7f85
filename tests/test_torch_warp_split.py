"""The row split of the warp-per-lane kernels, emulated on the CPU.

ops/csrc/graph_sw.cu (K3) and ops/csrc/paired_sw.cu (K1, K2) give each
lane (one read orientation) a group of G threads and each thread R =
ceil(M / G) consecutive read rows (ops/csrc/sw_warp.cuh). Per column a
thread takes its rows' H' and the prefix max of H' - (distance) gapE over
its own rows; an exclusive scan of those carries over the G threads
(log2 G shuffle steps, each shifted by d R gapE) gives the value entering
its first row; a second pass gives F, H and E (E clamped at 0). Each
thread keeps its own end cell (best over its stripe rows, first column,
first row, on a strict >) and its own running node maximum over real rows;
the group reduces the end cells in gssw's order (K3: lexicographic on
(score, column, row); K1: the TPU kernel's packed word) and a node's
maxima at its last column.

The emulation below does exactly that with torch ops, [G, R, B] at a
time, and is held to the plain fills (graph_fill_reference,
paired_fill_reference) and, on two cases, to the JAX package's
PallasGraphSW / PairedGraphSW in interpret mode. Integer DP outputs:
equality is exact.
"""
import random

import numpy as np
import pytest
import torch

from paragraph_tpu.ops import multi_sw as jax_msw
from paragraph_tpu.ops import pallas_sw as jax_psw
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.ops import pallas_sw as psw
from paragraph_tpu_torch.ops.batched_sw import GraphArrays, encode_reads

from test_gssw_vs_reference import _read_from_graph
from test_torch_paired_sw import FILL_CASES, LEGACY
from test_torch_paired_sw import _case as paired_case
from test_torch_pallas_sw import CASES as GRAPH_CASES
from test_torch_pallas_sw import SCORER_CASES
from test_torch_pallas_sw import _case as graph_case
from torch_twins import jax_graph, jax_graphs

BIG = 2 ** 30
NEG = -(2 ** 30)
GROUPS = (8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def warp_split_columns(ref, node, start, last, preds, x, lens, vlens, G,
                       gap_open, gap_extend, match, mismatch, carry=None,
                       keep_boundary=False):
    """The warp-per-lane fill of lanes that share one column stream.

    ref / node / start / last: the columns (python ints); preds: the
    predecessor table [N][P] (value N = zero state); x: int32 [M, B]
    codes in each lane's orientation; lens / vlens: [B]. Returns, per group
    and lane, (best, best column, best global row) [G, B] each, and the
    node maxima [N, B].

    The rows above these M (the row bands of sw_warp.cuh): `carry` =
    (diag [L, B], A [L, B]) gives, per column, the H entering it at the
    row above row 0 (thread 0's diagonal, else 0) and the F carry A
    entering row 0 (else none); `keep_boundary` appends the same two of
    this block's last row, for the block below."""
    M, B = x.shape
    N = len(preds)
    R = -(M // -G)
    i32 = torch.int32
    codes = torch.full((G * R, B), 5, dtype=i32)
    codes[:M] = x
    codes = codes.view(G, R, B)
    j = torch.arange(G * R, dtype=i32).view(G, R, 1)  # global row
    r_idx = torch.arange(R, dtype=i32).view(1, R, 1)
    g_idx = torch.arange(G, dtype=i32).view(G, 1)
    stripe = j < torch.clamp(vlens, max=M)
    real = j < torch.clamp(lens, max=M)
    prof_all = [torch.where(codes == c, match,
                            torch.where(codes < 4, -mismatch, 0)).to(i32)
                for c in range(4)] + [torch.zeros_like(codes)]
    decay = r_idx * gap_extend  # distance within a thread's rows

    h = torch.zeros((G, R, B), dtype=i32)
    e = torch.zeros((G, R, B), dtype=i32)
    saved_h = torch.zeros((N, G, R, B), dtype=i32)
    saved_e = torch.zeros((N, G, R, B), dtype=i32)
    node_max = torch.zeros((N, B), dtype=i32)
    node_run = torch.zeros((G, B), dtype=i32)
    best = torch.zeros((G, B), dtype=i32)
    best_col = torch.zeros((G, B), dtype=i32)
    best_row = torch.zeros((G, B), dtype=i32)
    diag_out = torch.zeros((len(ref), B), dtype=i32)
    a_out = torch.zeros((len(ref), B), dtype=i32)
    for c in range(len(ref)):
        nid = node[c]
        if start[c]:
            h = torch.zeros_like(h)
            e = torch.zeros_like(e)
            for pq in preds[nid]:
                if pq < N:  # slot N, the zero state, adds nothing
                    h = torch.maximum(h, saved_h[pq])
                    e = torch.maximum(e, saved_e[pq])
            node_run = torch.zeros_like(node_run)
        diag_out[c] = h[-1, -1]
        # diagonal: a thread's first row takes its neighbour's last row,
        # thread 0's the carried one (or 0)
        up0 = torch.zeros((1, 1, B), dtype=i32) if carry is None else \
            carry[0][c].view(1, 1, B)
        up = torch.cat([up0, h[:-1, -1:]])
        diag = torch.cat([up, h[:, :-1]], 1)
        hp = torch.clamp_min(torch.maximum(diag + prof_all[ref[c]], e), 0)
        # thread-local prefix: A_r = max_{k<=r} (hp_k - (r-k) gapE)
        run = torch.cummax(hp + decay, 1).values - decay
        # exclusive scan of the threads' carries, log2 G shuffle steps;
        # a carried A joins thread 0's, decayed over its R rows
        s = run[:, -1]
        if carry is not None:
            s = torch.cat([torch.maximum(s[:1], carry[1][c] - R * gap_extend),
                           s[1:]])
        d = 1
        while d < G:
            o = torch.where(g_idx >= d, torch.roll(s, d, 0), s)
            s = torch.maximum(o - d * R * gap_extend, s)
            d *= 2
        a_out[c] = s[-1]  # A after the last row
        a_first = NEG if carry is None else carry[1][c]
        a_in = torch.where(g_idx == 0, a_first, torch.roll(s, 1, 0))  # [G, B]
        # A entering row r: the carry decayed over r rows, or this
        # thread's own rows above r
        own = torch.cat([torch.full((G, 1, B), NEG, dtype=i32),
                         run[:, :-1]], 1)
        a = torch.maximum(a_in[:, None] - decay, own)
        hn = torch.clamp_min(torch.maximum(a - gap_open, hp), 0)
        e = torch.clamp_min(torch.maximum(e - gap_extend, hn - gap_open), 0)
        h = hn
        # per thread: end cell over stripe rows, node run over real rows
        col_max = torch.where(stripe, hn, 0).amax(1)
        first = torch.where(stripe & (hn == col_max[:, None]), j, BIG)
        upd = col_max > best
        best = torch.where(upd, col_max, best)
        best_col = torch.where(upd, c, best_col)
        best_row = torch.where(upd, first.amin(1), best_row)
        node_run = torch.maximum(node_run, torch.where(real, hn, 0).amax(1))
        if last[c]:
            saved_h[nid] = h
            saved_e[nid] = e
            node_max[nid] = node_run.amax(0)  # the group's reduction
    if keep_boundary:
        return best, best_col, best_row, node_max, diag_out, a_out
    return best, best_col, best_row, node_max


def reduce_lexicographic(best, col, row):
    """Highest score, then lowest column, then lowest row over the group."""
    score = best.amax(0)
    cand = best == score
    col_min = torch.where(cand, col, BIG).amin(0)
    cand &= col == col_min
    return score, col_min, torch.where(cand, row, BIG).amin(0)


def reduce_packed(best, col, row, col_bits, j_bits):
    """The TPU kernel's packed word (score | inverted column | inverted
    row), its max over the group, unpacked."""
    lmask = (1 << col_bits) - 1
    jmask = (1 << j_bits) - 1
    word = ((best << (col_bits + j_bits)) + ((lmask - col) << j_bits)
            + (jmask - row)).amax(0)
    return (word >> (col_bits + j_bits),
            lmask - ((word >> j_bits) & lmask), jmask - (word & jmask))


def _outputs(score, col, row, node_max, lens):
    zero = score == 0
    n_top = (node_max == score).sum(0)
    return torch.stack([
        score, torch.where(zero, -1, col),
        torch.where(zero, 0, torch.minimum(row, lens - 1)),
        (n_top > 1).to(torch.int32)]).to(torch.int32)


def warp_split_graph_fill(t, gap_open=6, gap_extend=1, match=1,
                          mismatch=4, *, G=32):
    """graph_sw.cu's decomposition of graph_fill: [4, B] int32."""
    best, col, row, node_max = warp_split_columns(
        t.ref_codes.tolist(), t.col_node.tolist(), t.is_start.tolist(),
        t.is_last.tolist(), t.pred_table.tolist(),
        t.read_codes_t.to(torch.int32), t.lens[0], t.vlens[0], G, gap_open,
        gap_extend, match, mismatch)
    return _outputs(*reduce_lexicographic(best, col, row), node_max,
                    t.lens[0])


def warp_split_paired_fill(t, gap_open=6, gap_extend=1, match=1,
                           mismatch=4, *, G=32, reduction="packed"):
    """paired_sw.cu's decomposition of paired_fill, tile by tile: [4, B]
    int32."""
    x, lens, vlens = msw.expand_orientations(t)
    M, B = x.shape
    T = t.tile_event.shape[0]
    TB = B // T
    col_bits, j_bits = msw._pack_split(t.l_ev, M, match)
    pc = t.packed_cols.tolist()
    out = torch.zeros((4, B), dtype=torch.int32)
    for tile in range(T):
        c0 = int(t.tile_col_start[tile])
        cols = pc[c0:c0 + int(t.tile_col_len[tile])]
        lanes = slice(tile * TB, (tile + 1) * TB)
        best, col, row, node_max = warp_split_columns(
            [w & 7 for w in cols], [(w >> 3) & 0xFFF for w in cols],
            [(w >> 15) & 1 for w in cols], [(w >> 16) & 1 for w in cols],
            t.pred_tables[int(t.tile_event[tile])].tolist(), x[:, lanes],
            lens[lanes], vlens[lanes], G, gap_open, gap_extend, match,
            mismatch)
        if reduction == "packed":
            score, col, row = reduce_packed(best, col, row, col_bits, j_bits)
        else:
            score, col, row = reduce_lexicographic(best, col, row)
        out[:, lanes] = _outputs(score, c0 + col, row, node_max,
                                 lens[lanes])
    return out


def _graph_tables(g, reads, M=None):
    max_len = max(len(r) for r in reads)
    codes, lens, vlens = encode_reads(reads, M or -(max_len // -32) * 32)
    return psw.graph_tables_from_numpy(GraphArrays.build(g), codes.T, lens,
                                       vlens, "cpu")


def _paired_tables(graphs, rpp):
    pairs = []
    for g in graphs:
        pairs.extend([g, g.reversed()])
    a = msw.MultiGraphArrays(pairs)
    return msw.tables_from_numpy(
        msw.build_pair_tables(a, rpp, msw.TILE_LANES), a, "cpu")


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_split_matches_plain_fill(name, G):
    t = _graph_tables(*graph_case(**GRAPH_CASES[name]))
    assert torch.equal(warp_split_graph_fill(t, G=G),
                       psw.graph_fill_reference(t))


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", sorted(SCORER_CASES))
def test_graph_split_matches_plain_fill_on_scorer_cases(name, G):
    t = _graph_tables(*SCORER_CASES[name])
    assert torch.equal(warp_split_graph_fill(t, G=G),
                       psw.graph_fill_reference(t))


def test_graph_split_with_large_scores():
    """match=100000: no packed word, so no limit on the score's bits."""
    g, reads = graph_case(seed=46, max_nodes=3, max_len=12, read_lens=(6, 20))
    t = _graph_tables(g, reads)
    got = warp_split_graph_fill(t, match=100000)
    assert torch.equal(got, psw.graph_fill_reference(t, match=100000))
    assert int(got[0].max()) >= 100000


@pytest.mark.parametrize("reduction", ["packed", "lexicographic"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_paired_split_matches_plain_fill(name, G, reduction):
    t = _paired_tables(*paired_case(**FILL_CASES[name]))
    assert torch.equal(warp_split_paired_fill(t, G=G, reduction=reduction),
                       msw.paired_fill_reference(t))


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", sorted(LEGACY))
def test_paired_split_matches_plain_fill_on_scorer_cases(name, G):
    t = _paired_tables(*LEGACY[name])
    assert torch.equal(warp_split_paired_fill(t, G=G),
                       msw.paired_fill_reference(t))


def _long_case(seed, M):
    """A graph of a few long nodes and reads up to M bases drawn from it,
    with mismatches and indels."""
    rng = random.Random(seed)
    n = 4
    seqs = ["".join(rng.choice("ACGT") for _ in range(max(4, M // 3)))
            for _ in range(n)]
    edges = [(0, 1), (0, 2), (1, 2), (2, 3), (1, 3)]
    g = SequenceGraph([f"n{i}" for i in range(n)], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    reads = [_read_from_graph(rng, seqs, edges, read_len=rng.randint(
        max(2, M // 2), M), mutate=0.05, indel=0.02)[:M] for _ in range(5)]
    return g, [r for r in reads if r] + ["ACGT" * (M // 4)]


_PLAIN = {}


def _long_plain(M):
    """(tables, plain output) of _long_case at M rows, single-graph and
    (where M is a multiple of 32, as the paired tables round it) paired;
    computed once per M."""
    if M not in _PLAIN:
        g, reads = _long_case(M, M)
        t = _graph_tables(g, reads, M)
        cases = [(t, psw.graph_fill_reference(t))]
        if M % 32 == 0:
            tp = _paired_tables([g], [reads])
            cases.append((tp, msw.paired_fill_reference(tp)))
        _PLAIN[M] = cases
    return _PLAIN[M]


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("M", [16, 48, 160, 272, 512, 800])
def test_split_over_read_rows(M, G):
    """Every M from one row per thread to past the largest R the kernels
    instantiate (26 rows of 32 threads = 832 >= 800), for both fills."""
    cases = _long_plain(M)
    t, want = cases[0]
    assert t.read_codes_t.shape[0] == M
    assert torch.equal(warp_split_graph_fill(t, G=G), want)
    for t, want in cases[1:]:
        assert t.base_codes_t.shape[0] == M
        assert torch.equal(warp_split_paired_fill(t, G=G), want)


def test_graph_split_matches_jax_scorer(monkeypatch):
    """SingleGraphSW with the emulated split as its fill == the JAX
    package's PallasGraphSW in interpret mode."""
    g, reads = SCORER_CASES["mixed_6_150"]
    monkeypatch.setattr(psw, "graph_fill_reference", warp_split_graph_fill)
    got = psw.SingleGraphSW(g, tile_batch=32, device="cpu").score(reads)
    want = jax_psw.PallasGraphSW(jax_graph(g), tile_batch=32,
                                 interpret=True).score(reads)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_paired_split_matches_jax_scorer(monkeypatch):
    """PairedGraphSW with the emulated split as its fill == the JAX
    package's PairedGraphSW in interpret mode."""
    graphs, rpp = LEGACY["paired_909"]
    monkeypatch.setattr(msw, "paired_fill_reference", warp_split_paired_fill)
    got = msw.PairedGraphSW(graphs, device="cpu").score_pairs(rpp)
    want = jax_msw.PairedGraphSW(jax_graphs(graphs),
                                 interpret=True).score_pairs(rpp)
    for g, w in zip(got, want):
        for side in range(2):
            for x, y in zip(g[side], w[side]):
                np.testing.assert_array_equal(x, y)
