"""The row bands of the warp-per-lane kernels, emulated on the CPU.

Reads longer than one warp's rows (26 rows x 32 threads = 832) take the
band path of ops/csrc/sw_warp.cuh (band_lane): a lane's rows are cut into
bands of G threads x R rows, each band sweeps all of the lane's columns
with the same column step, and band b + 1 takes from band b, per column,
the H entering the column at band b's last row (thread 0's diagonal) and
the F carry A after that row (thread 0's incoming A, joined into the
scan). Node maxima are the max over bands; the end cell is merged over
bands in (score, lowest column, lowest row) order with global rows.

The emulation below does that on top of test_torch_warp_split.py's
warp_split_columns, at a small band (G = 8 threads x 2 rows = 16 rows) so
that bands occur at small M, and at the kernels' own (32 x 26 = 832), and
is held to the plain fills (graph_fill_reference, paired_fill_reference)
at M = 40 to 2048, with reads whose best cell sits exactly on a band's
last or first row. Dropping the carried A or the carried diagonal makes it
fail. Beside it, the port's plain K3 fill at M = 900-2048 is held to the
JAX package's scorer. Integer DP outputs: equality is exact.
"""
import numpy as np
import pytest
import torch

from paragraph_tpu.ops import pallas_sw as jax_psw
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.ops import pallas_sw as psw
from paragraph_tpu_torch.ops.batched_sw import GraphArrays, pack_bits

from test_torch_cuda import _short_graph_long_reads
from test_torch_paired_sw import FILL_CASES
from test_torch_paired_sw import _case as paired_case
from test_torch_pallas_sw import CASES as GRAPH_CASES
from test_torch_pallas_sw import _case as graph_case
from test_torch_warp_split import (_graph_tables, _long_case, _outputs,
                                   _paired_tables, reduce_lexicographic,
                                   warp_split_columns)
from torch_twins import jax_graph

NEG = -(2 ** 30)
SMALL = (8, 2)    # G threads x R rows: 16-row bands
KERNEL = (32, 26)  # the kernels' bands: 832 rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def band_split_columns(ref, node, start, last, preds, x, lens, vlens, band,
                       gap_open, gap_extend, match, mismatch, mutate=None):
    """band_lane of sw_warp.cuh on lanes that share one column stream:
    (score, column, global row) [B] merged over the bands, node maxima
    [N, B]. `mutate` drops one carried word ("diag": thread 0's diagonal
    back to 0; "carry": its incoming A back to none)."""
    G, R = band
    H = G * R
    M, B = x.shape
    i32 = torch.int32
    node_max = torch.zeros((len(preds), B), dtype=i32)
    best = torch.zeros(B, dtype=i32)
    col = torch.zeros(B, dtype=i32)
    row = torch.zeros(B, dtype=i32)
    carry = None
    for off in range(0, M, H):
        xb = torch.full((H, B), 5, dtype=i32)
        xb[:min(H, M - off)] = x[off:off + H]
        bb, bc, br, nm, diag, a = warp_split_columns(
            ref, node, start, last, preds, xb, lens - off, vlens - off, G,
            gap_open, gap_extend, match, mismatch, carry=carry,
            keep_boundary=True)
        s, c, r = reduce_lexicographic(bb, bc, br + off)
        upd = (s > best) | ((s == best) & ((c < col) | ((c == col)
                                                         & (r < row))))
        best = torch.where(upd, s, best)
        col = torch.where(upd, c, col)
        row = torch.where(upd, r, row)
        node_max = torch.maximum(node_max, nm)
        if mutate == "diag":
            diag = torch.zeros_like(diag)
        elif mutate == "carry":
            a = torch.full_like(a, NEG)
        carry = (diag, a)
    return best, col, row, node_max


def band_graph_fill(t, band, gap_open=6, gap_extend=1, match=1, mismatch=4,
                    mutate=None):
    """graph_sw.cu's band kernel as an emulation: [4, B] int32."""
    best, col, row, node_max = band_split_columns(
        t.ref_codes.tolist(), t.col_node.tolist(), t.is_start.tolist(),
        t.is_last.tolist(), t.pred_table.tolist(),
        t.read_codes_t.to(torch.int32), t.lens[0], t.vlens[0], band,
        gap_open, gap_extend, match, mismatch, mutate)
    return _outputs(best, col, row, node_max, t.lens[0])


def band_paired_fill(t, band, gap_open=6, gap_extend=1, match=1,
                     mismatch=4, mutate=None):
    """paired_sw.cu's band kernel as an emulation, tile by tile: [4, B]
    int32."""
    x, lens, vlens = msw.expand_orientations(t)
    B = x.shape[1]
    T = t.tile_event.shape[0]
    TB = B // T
    msw._pack_split(t.l_ev, x.shape[0], match)  # the kernel's refusal
    pc = t.packed_cols.tolist()
    out = torch.zeros((4, B), dtype=torch.int32)
    for tile in range(T):
        c0 = int(t.tile_col_start[tile])
        cols = pc[c0:c0 + int(t.tile_col_len[tile])]
        lanes = slice(tile * TB, (tile + 1) * TB)
        best, col, row, node_max = band_split_columns(
            [w & 7 for w in cols], [(w >> 3) & 0xFFF for w in cols],
            [(w >> 15) & 1 for w in cols], [(w >> 16) & 1 for w in cols],
            t.pred_tables[int(t.tile_event[tile])].tolist(), x[:, lanes],
            lens[lanes], vlens[lanes], band, gap_open, gap_extend, match,
            mismatch, mutate)
        out[:, lanes] = _outputs(best, c0 + col, row, node_max, lens[lanes])
    return out


def _path(g):
    """The sequence of the path through node 0 and each node's first
    successor."""
    n, seq = 0, g.node_seq(0)
    while g.successors(n):
        n = g.successors(n)[0]
        seq += g.node_seq(n)
    return seq


def _boundary_reads(g, H):
    """Exact substrings of the graph's path of H - 1, H, H + 1 and 2H + 1
    bases, whose best cells end on the rows around the first two band
    boundaries, and a read of the path with 8 bases inserted across a
    boundary after at least 21 matches (a vertical gap that the best
    alignment takes, so F carries over the boundary)."""
    seq = _path(g)
    reads = [seq[:k] for k in (H - 1, H, H + 1, 2 * H + 1) if k <= len(seq)]
    at = -(-24 // H) * H - 3
    if len(seq) >= at + 24:
        reads.append(seq[:at] + "TTGACCAT" + seq[at:at + 24])
    return reads


def _ends_on_boundary(out, H):
    rows = out[2][out[0] > 0]
    return bool(((rows % H == 0) | (rows % H == H - 1)).any())


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_bands_match_plain_fill(name):
    g, reads = graph_case(**GRAPH_CASES[name])
    t = _graph_tables(g, reads + _boundary_reads(g, 16))
    want = psw.graph_fill_reference(t)
    assert torch.equal(band_graph_fill(t, SMALL), want)


@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_paired_bands_match_plain_fill(name):
    graphs, rpp = paired_case(**FILL_CASES[name])
    rpp = [r + _boundary_reads(g, 16) if r else r
           for g, r in zip(graphs, rpp)]
    t = _paired_tables(graphs, rpp)
    assert torch.equal(band_paired_fill(t, SMALL),
                       msw.paired_fill_reference(t))


@pytest.mark.parametrize("M", [40, 160, 833, 1024, 2048])
def test_graph_bands_over_read_rows(M):
    """K3's band path on _long_case (graphs of ~4 M / 3 columns) at every
    M, with reads ending on band boundaries: small bands at M <= 160,
    the kernels' 832-row bands above."""
    band = SMALL if M <= 160 else KERNEL
    H = band[0] * band[1]
    g, reads = _long_case(M, M)
    t = _graph_tables(g, [r[:M] for r in reads + _boundary_reads(g, H)], M)
    assert t.read_codes_t.shape[0] == -(M // -16) * 16  # the row stripe
    want = psw.graph_fill_reference(t)
    assert _ends_on_boundary(want, H)
    assert torch.equal(band_graph_fill(t, band), want)


@pytest.mark.parametrize("M", [40, 160, 833, 1024, 2048])
def test_paired_bands_over_read_rows(M):
    """K1's band path at every M (the paired tables round M up to a
    multiple of 32): _long_case at M <= 160 with small bands; above, a
    graph short enough for the packed end-cell word and reads of up to M
    bases with the kernels' 832-row bands."""
    if M <= 160:
        band = SMALL
        g, reads = _long_case(M, M)
        reads = reads + _boundary_reads(g, 16)
    else:
        band = KERNEL
        g, reads = _short_graph_long_reads(M, seed=M)
    t = _paired_tables([g], [reads])
    assert t.base_codes_t.shape[0] == -(M // -32) * 32
    want = msw.paired_fill_reference(t)
    assert _ends_on_boundary(want, band[0] * band[1])
    assert torch.equal(band_paired_fill(t, band), want)


@pytest.mark.parametrize("mutate", ["diag", "carry"])
def test_dropping_a_carried_word_fails(mutate):
    """Each carried word matters: without it the emulation no longer
    equals the plain fills."""
    g, reads = _long_case(160, 160)
    reads = reads + _boundary_reads(g, 16)
    t = _graph_tables(g, reads, 160)
    want = psw.graph_fill_reference(t)
    assert torch.equal(band_graph_fill(t, SMALL), want)
    assert not torch.equal(band_graph_fill(t, SMALL, mutate=mutate), want)
    tp = _paired_tables([g], [reads])
    want = msw.paired_fill_reference(tp)
    assert not torch.equal(band_paired_fill(tp, SMALL, mutate=mutate), want)


@pytest.mark.parametrize("M", [900, 1500, 2048])
def test_plain_fill_matches_jax_scorer_on_long_reads(M):
    """The port's plain K3 fill (SingleGraphSW on the CPU) at M = 900-2048
    against the JAX package's scorer: PallasGraphSW in interpret mode
    where its packed word holds the scores, else (it falls back itself)
    its scan BatchedGraphSW."""
    g, reads = _short_graph_long_reads(M, seed=M, n_cols=600)
    reads = [r[:M] for r in reads]
    got = psw.SingleGraphSW(g, tile_batch=32, device="cpu").score(reads)
    a = GraphArrays.build(g)
    packed = pack_bits(len(a.ref_codes), -(M // -32) * 32, 1) is not None
    want = jax_psw.PallasGraphSW(jax_graph(g), tile_batch=32,
                                 interpret=True).score(reads)
    assert packed == (M <= 1024)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y).astype(x.dtype))
