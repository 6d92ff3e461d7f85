"""K4's warp-per-lane layout (ops/csrc/kbench_warp.cuh), emulated on the CPU.

The ablation kernel runs the paired fill's column step with a warp per
lane, as K1 does (tests/test_torch_warp_split.py emulates that split), and
gives each knob of the JAX harness (tools/kbench2.py) a meaning on that
layout: no F, no end cell, no node branches, masks hoisted into additive
terms built at lane start, two columns per loop trip, a profile table, a
per-row best word and node run reduced at node ends and at the lane's
end, and E unclamped but seeded from 0. The emulation below does what the
kernel does, [G, R, B] at a time, for every variant, and is held to
kbench_fill_reference (the plain fill with the variant's functional
switches) at G = 8, 16 and 32 (tests/test_torch_kbench.py holds it to
the JAX harness's build_fill in interpret mode). Integer DP outputs:
equality is exact.
"""
import os
import random
import re

import pytest
import torch

from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.tools import kbench2

from test_gssw_vs_reference import _random_graph, _read_from_graph
from test_torch_kbench import M_RULE, READ_LEN, _graph_and_reads
from test_torch_warp_split import _outputs, reduce_lexicographic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = 2 ** 30
NEG = -(2 ** 30)  # kNeg, INT_MIN / 2
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


def knobs(variant):
    """The kernel's knobs of a variant, from the JAX harness's keywords:
    the make_kernel variants keep the per-row arrays, every variant but
    opt1_iprof the profile table, every variant but make_kernel_opt2's
    the clamp of E."""
    kw = kbench2.VARIANTS[variant]
    return dict(scan=kw.get("scan", True), track=kw.get("track", True),
                branches=kw.get("branches", True),
                hoist=kw.get("hoist", False), unroll=kw.get("unroll", 1),
                prof_table=not kw.get("inline_prof", False),
                row_arrays=not (kw.get("_opt") or kw.get("_opt2")),
                clamp_e=not kw.get("_opt2", False))


def _shfl_up(x, d):
    """__shfl_up_sync over dim 0: thread t takes thread t - d's value,
    threads t < d their own."""
    return torch.cat([x[:d], x[:-d]])


def kbench_warp_columns(cols, preds, x, lens, vlens, G, k, col_bits,
                        gap_open, gap_extend, match, mismatch):
    """One tile of the ablation kernel: the lanes of x (int32 [M, B] codes
    in orientation, lens / vlens [B]) over the packed column words `cols`
    with the predecessor table `preds` [N][P] (value N = zero state).
    Returns each thread's end cell (best, best column, best global row)
    [G, B] each, before the warp's reduction, and the node maxima [N, B]."""
    M, B = x.shape
    N = len(preds)
    R = -(M // -G)
    i32 = torch.int32
    codes = torch.full((G * R, B), 5, dtype=i32)
    codes[:M] = x
    codes = codes.view(G, R, B)
    j = torch.arange(G * R, dtype=i32).view(G, R, 1)
    r_idx = torch.arange(R, dtype=i32).view(1, R, 1)
    g_idx = torch.arange(G, dtype=i32).view(G, 1)
    stripe = j < torch.clamp(vlens, max=M)
    real = j < torch.clamp(lens, max=M)
    zero = torch.zeros((G, R, B), dtype=i32)
    # the hoisted masks
    ks = torch.where(stripe, 0, NEG)
    kn = torch.where(real, 0, NEG)
    up_keep = torch.where(g_idx == 0, 0, -1)
    a_kill = torch.where(g_idx == 0, NEG, 0)
    table = torch.stack(
        [torch.where(codes == c, match, torch.where(codes < 4, -mismatch, 0))
         for c in range(4)] + [zero]).to(i32)

    def profile(ref):
        if k["prof_table"]:
            return table[min(ref, 4)]
        if ref >= 4:  # column_bits: N or pad scores 0
            return zero
        eq = codes == ref
        return torch.where(eq, match, torch.where((codes < 4) & ~eq,
                                                  -mismatch, 0)).to(i32)

    decay = r_idx * gap_extend
    h, e = zero.clone(), zero.clone()
    saved_h = torch.zeros((N, G, R, B), dtype=i32)
    saved_e = torch.zeros((N, G, R, B), dtype=i32)
    node_max = torch.zeros((N, B), dtype=i32)
    node_run = torch.zeros((G, B), dtype=i32)
    row_best, row_run = zero.clone(), zero.clone()
    best = torch.zeros((G, B), dtype=i32)
    best_col = torch.zeros((G, B), dtype=i32)
    best_row = torch.zeros((G, B), dtype=i32)
    lmask = (1 << col_bits) - 1
    if len(cols) % k["unroll"]:
        raise ValueError("odd column count")
    for c, pc in enumerate(cols):
        ref, nid = pc & 7, (pc >> 3) & 0xFFF
        start, last = (pc >> 15) & 1, (pc >> 16) & 1
        if k["branches"] and start:
            h, e = zero.clone(), zero.clone()
            for q in preds[nid]:
                if q < N:
                    h = torch.maximum(h, saved_h[q])
                    e = torch.maximum(e, saved_e[q])
            node_run = torch.zeros_like(node_run)
        up = _shfl_up(h[:, -1], 1)
        up = up & up_keep if k["hoist"] else torch.where(g_idx == 0, 0, up)
        diag = torch.cat([up[:, None], h[:, :-1]], 1)
        hp = torch.clamp_min(torch.maximum(diag + profile(ref), e), 0)
        hn = hp
        if k["scan"]:
            run = torch.cummax(hp + decay, 1).values - decay
            s = run[:, -1]
            d = 1
            while d < G:
                s = torch.maximum(_shfl_up(s, d) - d * R * gap_extend, s)
                d *= 2
            a_in = _shfl_up(s, 1)
            a_in = a_in + a_kill if k["hoist"] else torch.where(
                g_idx == 0, NEG, a_in)
            own = torch.cat([torch.full((G, 1, B), NEG, dtype=i32),
                             run[:, :-1]], 1)
            a = torch.maximum(a_in[:, None] - decay, own)
            hn = torch.clamp_min(torch.maximum(a - gap_open, hp), 0)
        h = hn
        e = torch.maximum(e - gap_extend, hn - gap_open)
        if k["clamp_e"]:
            e = torch.clamp_min(e, 0)
        if k["row_arrays"]:
            if k["track"]:
                word = (hn << col_bits) + (lmask - c)
                row_best = torch.maximum(
                    row_best, word + ks if k["hoist"]
                    else torch.where(stripe, word, 0))
            row_run = hn if (k["branches"] and start) else torch.maximum(
                row_run, hn)
            node_end = torch.clamp_min((row_run + kn).amax(1), 0) \
                if k["hoist"] else torch.where(real, row_run, 0).amax(1)
        else:
            if k["track"]:
                col_max = torch.clamp_min((hn + ks).amax(1), 0) \
                    if k["hoist"] else torch.where(stripe, hn, 0).amax(1)
                first = torch.where(stripe & (hn == col_max[:, None]), j,
                                    BIG).amin(1)
                upd = col_max > best
                best = torch.where(upd, col_max, best)
                best_col = torch.where(upd, c, best_col)
                best_row = torch.where(upd, first, best_row)
            node_run = torch.maximum(node_run, torch.clamp_min(
                (hn + kn).amax(1), 0) if k["hoist"]
                else torch.where(real, hn, 0).amax(1))
            node_end = node_run
        if k["branches"] and last:
            saved_h[nid] = h
            saved_e[nid] = e
            node_max[nid] = node_end.amax(0)
    if k["track"] and k["row_arrays"]:
        # each thread's rows in order on a strict >: the highest word,
        # then the lowest row
        word = row_best.amax(1)
        row = torch.where(row_best == word[:, None], r_idx, BIG).amin(1)
        best = word >> col_bits
        best_col = lmask - (word & lmask)
        best_row = g_idx * R + torch.where(word > 0, row, 0)
    return best, best_col, best_row, node_max


def kbench_warp_fill(t, variant, G=32):
    """The ablation kernel's decomposition of a variant's fill on K2's
    tables, tile by tile: [4, B] int32."""
    k = knobs(variant)
    M, B = t.read_codes_t.shape
    scoring = kbench2.SCORING
    col_bits, _ = msw._pack_split(t.l_ev, M, scoring["match"])
    x = t.read_codes_t.to(torch.int32)
    lens, vlens = t.lens[0], t.vlens[0]
    T = t.tile_event.shape[0]
    TB = B // T
    pc = t.packed_cols.tolist()
    out = torch.zeros((4, B), dtype=torch.int32)
    for tile in range(T):
        c0 = int(t.tile_col_start[tile])
        lanes = slice(tile * TB, (tile + 1) * TB)
        best, col, row, node_max = kbench_warp_columns(
            pc[c0:c0 + int(t.tile_col_len[tile])],
            t.pred_tables[int(t.tile_event[tile])].tolist(), x[:, lanes],
            lens[lanes], vlens[lanes], G, k, col_bits, **scoring)
        if k["track"]:
            score, col, row = reduce_lexicographic(best, col, row)
        else:
            score = col = row = torch.zeros(TB, dtype=torch.int32)
        out[:, lanes] = _outputs(score, c0 + col, row, node_max, lens[lanes])
    return out


def _bubble():
    """tests/test_torch_kbench.py's case: the bubble graph and its
    reversal as one paired dispatch, expanded, at the --m rule's rows."""
    g, reads = _graph_and_reads()
    pairs = [g, g.reversed()]
    a = msw.MultiGraphArrays(pairs)
    host = msw.build_pair_tables(a, [reads], msw.TILE_LANES)
    rows = max(kbench2.rows_for(M_RULE, READ_LEN), host["m"])
    return kbench2.expanded_tables(msw.tables_from_numpy(host, a, "cpu"),
                                   rows)


def _multi_tables(graphs, rpe):
    sw = msw.MultiGraphSW(graphs, device="cpu")
    return sw.tables(0, rpe)[0]


def _ragged_rows():
    """Three random graphs (up to three predecessors per node) and reads
    of 6 to 150 bases, so their row counts fall anywhere in a thread's R
    rows, at M = 160."""
    rng = random.Random(81)
    graphs, rpe = [], []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=6, max_len=40)
        g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
        for f, t in edges:
            g.add_edge(f, t)
        graphs.append(g)
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(6, 150))
                 for _ in range(rng.randint(10, 30))]
        rpe.append([r for r in reads if r])
    return _multi_tables(graphs, rpe)


def _many_preds():
    """A graph of 24 short nodes, each with up to five predecessors among
    the eight before it, and reads drawn from it."""
    rng = random.Random(82)
    n = 24
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(1, 8)))
            for _ in range(n)]
    edges = []
    for t in range(1, n):
        window = range(max(0, t - 8), t)
        edges.extend((f, t) for f in sorted(
            rng.sample(window, min(len(window), rng.randint(1, 5)))))
    g = SequenceGraph([f"n{i}" for i in range(n)], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    reads = [_read_from_graph(rng, seqs, edges, read_len=rng.randint(20, 80))
             for _ in range(40)]
    return _multi_tables([g], [[r for r in reads if r]])


def _repeats():
    """Homopolymer reads on a homopolymer graph, where a fault in thread
    0's gates (the diagonal or the F carry it takes from no neighbour)
    runs down every diagonal to the end cell; and reads whose one T
    matches one column of a C graph, so the best score ties over rows of
    one column and the lowest row has to win."""
    rng = random.Random(83)
    graphs = []
    for seqs in (["A" * 40, "A" * 30, "A" * 20], ["C" * 20, "T", "C" * 20]):
        g = SequenceGraph([f"n{i}" for i in range(3)], seqs)
        for f, t in [(0, 1), (0, 2), (1, 2)]:
            g.add_edge(f, t)
        graphs.append(g)
    rpe = [["A" * rng.randint(6, 100) for _ in range(12)],
           ["G" * rng.randint(0, 4) + "T" * rng.randint(2, 6)
            + "G" * rng.randint(0, 9) for _ in range(12)]]
    return _multi_tables(graphs, rpe)


CASES = {"bubble": _bubble, "ragged_rows": _ragged_rows,
         "many_preds": _many_preds, "repeats": _repeats}
_TABLES, _PLAIN = {}, {}


def _plain(case, variant):
    """(tables, plain fill) of a case, each computed once per case and set
    of functional switches."""
    if case not in _TABLES:
        _TABLES[case] = CASES[case]()
    t = _TABLES[case]
    key = (case, tuple(kbench2._switches(variant).values()))
    if key not in _PLAIN:
        _PLAIN[key] = kbench2.kbench_fill_reference(t, variant)
    return t, _PLAIN[key]


def test_cases_cover_ragged_rows_and_several_predecessors():
    t, _ = _plain("ragged_rows", "v0")
    M = t.read_codes_t.shape[0]
    lens = t.lens[0][t.lens[0] > 1]  # pad lanes hold one base
    for G in GROUPS:
        R = -(M // -G)
        assert bool(((lens % R) != 0).any()) and R > 1
    t, _ = _plain("many_preds", "v0")
    assert t.pred_tables.shape[2] >= 4
    # rows past M in the last threads at G = 32
    assert _plain("bubble", "v0")[0].read_codes_t.shape[0] % 32 != 0


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("variant", list(kbench2.VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_layout_matches_plain_fill(case, variant, G):
    t, want = _plain(case, variant)
    assert torch.equal(kbench_warp_fill(t, variant, G=G), want)


def test_kernel_variant_table_matches_the_harness():
    """kbench_warp.cuh's Variant flags, in variant id order, are the knobs
    of kbench2.VARIANTS in its order."""
    path = os.path.join(ROOT, "paragraph_tpu_torch", "ops", "csrc",
                        "kbench_warp.cuh")
    with open(path) as f:
        rows = re.findall(r"^KBENCH_VARIANT\((\d+), ([^)]*)\)\s*// (\w+)",
                          f.read(), re.M)
    assert [(int(i), name) for i, _, name in rows] == list(
        enumerate(kbench2.VARIANTS))
    order = ("scan", "track", "branches", "hoist", "unroll", "prof_table",
             "row_arrays", "clamp_e")
    for _, flags, name in rows:
        got = [v.strip() for v in flags.split(",")]
        want = [str(knobs(name)[o]).lower() for o in order]
        assert got == want, name
