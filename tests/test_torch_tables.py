"""Host tables of the PyTorch port vs the JAX package's builders.

paragraph_tpu_torch/ops/{batched_sw,multi_sw}.py copy the numpy table
builders out of modules that import jax; every array they build must be
identical, dtype included (tolerance 0).

On a card the paired scorers build the read tables from staged bytes
(``stage_pair_tables``, ``pair_tables_kernel``); here the kernel's plain
version, ``pair_tables_reference``, on the same staging bytes, is held to
``build_pair_tables`` + ``dispatch_tables`` tensor by tensor.
"""
import random

import numpy as np
import pytest
import torch

from paragraph_tpu.ops import batched_sw as jax_bsw
from paragraph_tpu.ops import multi_sw as jax_msw
from paragraph_tpu.ops import pallas_sw as jax_psw
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import batched_sw as bsw
from paragraph_tpu_torch.ops import multi_sw as msw

from test_gssw_vs_reference import _random_graph, _read_from_graph
from torch_twins import jax_graph, jax_graphs


def _make_graph(seqs, edges):
    g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    return g


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: one thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_n(rng, s, frac):
    return "".join("N" if rng.random() < frac else c for c in s)


def _case(seed, n_pairs=4, n_frac=0.0, empty_every=0, max_len=40,
          read_lens=(6, 60)):
    rng = random.Random(seed)
    graphs, rpp = [], []
    for k in range(n_pairs):
        seqs, edges = _random_graph(rng, max_nodes=6, max_len=max_len)
        seqs = [_with_n(rng, s, n_frac) for s in seqs]
        graphs.append(_make_graph(seqs, edges))
        if empty_every and k % empty_every == 0:
            rpp.append([])
            continue
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(*read_lens))
                 for _ in range(rng.randint(1, 9))]
        rpp.append([_with_n(rng, r, n_frac) for r in reads if r])
    return graphs, rpp


CASES = {
    "random": dict(seed=1),
    "n_bases": dict(seed=2, n_frac=0.1),
    "mixed_lengths": dict(seed=3, read_lens=(6, 150), max_len=120),
    "empty_pairs": dict(seed=4, empty_every=2),
    "all_empty": dict(seed=5, empty_every=1),
}


def _assert_same(a, b, where=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert (a == b).all(), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_arrays_match(name, bucket):
    graphs, _ = _case(**CASES[name])
    for g in graphs:
        for gg in (g, g.reversed()):
            want = jax_bsw.GraphArrays.build(jax_graph(gg), bucket=bucket)
            got = bsw.GraphArrays.build(gg, bucket=bucket)
            for field in ("ref_codes", "col_node", "col_in_node",
                          "is_start", "is_last", "pred_table",
                          "num_nodes"):
                _assert_same(getattr(got, field), getattr(want, field),
                             field)


@pytest.mark.parametrize("pad_to", [0, 32, 160])
@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_reads_and_blob_match(name, pad_to):
    _, rpp = _case(**CASES[name])
    reads = [r for rs in rpp for r in rs]
    if reads:
        reads[0] = reads[0].lower()
    _assert_same(bsw.encode_reads(reads, pad_to),
                 jax_bsw.encode_reads(reads, pad_to), "encode_reads")
    blob = "".join(reads).upper().encode()
    lens = np.array([len(r) for r in reads], np.int32)
    _assert_same(bsw.encode_blob(blob, lens, pad_to),
                 jax_bsw.encode_blob(blob, lens, pad_to), "encode_blob")


def test_encode_uniform_lengths_match():
    reads = ["ACGTN" * 6] * 5
    _assert_same(bsw.encode_reads(reads), jax_bsw.encode_reads(reads))


@pytest.mark.parametrize("L,M,match", [
    (1, 1, 1), (2048, 160, 1), (65536, 160, 1), (1 << 20, 32, 1),
    (1 << 22, 32, 1), (1 << 24, 64, 1), (4096, 256, 9), (256, 4096, 1)])
def test_pack_bits_match(L, M, match):
    assert bsw.pack_bits(L, M, match) == jax_psw.pack_bits(L, M, match)


def _multi(graphs):
    pairs = []
    for g in graphs:
        pairs.append(g)
        pairs.append(g.reversed())
    return (msw.MultiGraphArrays(pairs),
            jax_msw.MultiGraphArrays(jax_graphs(pairs)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_graph_arrays_match(name):
    graphs, _ = _case(**CASES[name])
    got, want = _multi(graphs)
    for field in ("n_max", "p_max", "col_len", "col_start", "ref_codes",
                  "col_node", "col_in_node", "is_start", "is_last",
                  "packed_cols", "pred_tables"):
        _assert_same(getattr(got, field), getattr(want, field), field)


@pytest.mark.parametrize("n_nodes,fits", [(4091, True), (4095, False)])
def test_node_id_limit_refused_by_both(n_nodes, fits):
    """A chain of n_nodes one-base nodes; bucketing rounds n_nodes + 1 up
    to a multiple of 4, and 4096 node slots exceed the 12-bit id."""
    g = SequenceGraph([f"n{i}" for i in range(n_nodes)],
                      ["ACGT"[i % 4] for i in range(n_nodes)])
    for i in range(1, n_nodes):
        g.add_edge(i - 1, i)
    if fits:
        got = msw.MultiGraphArrays([g])
        want = jax_msw.MultiGraphArrays([jax_graph(g)])
        assert got.n_max == 4092
        _assert_same(got.packed_cols, want.packed_cols)
        _assert_same(got.pred_tables, want.pred_tables)
        return
    with pytest.raises(AssertionError):
        jax_msw.MultiGraphArrays([jax_graph(g)])
    with pytest.raises(ValueError, match="12-bit"):
        msw.MultiGraphArrays([g])


def _n_tiles(rpp, tb=128):
    return max(1, sum(jax_msw.pair_tiles(jax_msw.pair_count(r), tb)
                      for r in rpp))


def _assert_tables_match(got, want, n_tiles, tb=128):
    """The port's tables equal the JAX builder's, whose tile count is
    rounded up to a power of two with pad tiles (clen 0, lanes zeroed);
    the port builds no pad tiles."""
    assert sorted(got) == sorted(want)
    n_lanes = n_tiles * tb
    for key in want:
        w = want[key]
        if key.startswith("tile_"):
            assert (w[n_tiles:] == 0).all(), key
            w = w[:n_tiles]
        elif key == "col_idx":
            assert (w[n_lanes:] == 0).all(), key
            w = w[:n_lanes]
        elif key in ("flip", "comp"):
            assert (w[:, n_lanes:] == 0).all(), key
            w = w[:, :n_lanes]
        _assert_same(got[key], w, key)


@pytest.mark.parametrize("blobs", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_build_pair_tables_match(name, blobs):
    graphs, rpp = _case(**CASES[name])
    if blobs:
        rpp = [msw.pair_norm(r) for r in rpp]
    got_a, want_a = _multi(graphs)
    got = msw.build_pair_tables(got_a, rpp, 128)
    want = jax_msw.build_pair_tables(want_a, rpp, 128)
    _assert_tables_match(got, want, _n_tiles(rpp))
    assert got["col_idx"].dtype == np.int16


FILL_FIELDS = ("tile_col_start", "tile_col_len", "tile_event",
               "base_codes_t", "base_lens", "base_vlens", "col_idx", "flip",
               "comp")


def _cells(col_len, m):
    return int(np.asarray(col_len, np.int64).sum()) * msw.TILE_LANES * m


def _assert_staged_matches(a, rpp, jax_a=None):
    """pair_tables_reference on the staged bytes == the host tables on
    the CPU: every tensor in dtype, shape and value; layout, m, l_ev and
    the dispatch's cells. Given the JAX package's arrays of the same
    graphs, the host tables are held to its builder's too."""
    t = msw.build_pair_tables(a, rpp, msw.TILE_LANES)
    if jax_a is not None:
        _assert_tables_match(t, jax_msw.build_pair_tables(jax_a, rpp, 128),
                             _n_tiles(rpp))
    want = msw.tables_from_numpy(t, a, "cpu")
    s = msw.stage_pair_tables(a, rpp, msw.TILE_LANES)
    got = msw.pair_tables_reference(msw.staging_tensor(s, pin=False), s,
                                    want.packed_cols, want.pred_tables)
    for field in FILL_FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        assert x.dtype == y.dtype and x.shape == y.shape, (
            field, x.dtype, y.dtype, x.shape, y.shape)
        assert torch.equal(x, y), field
    _assert_same(s.layout, t["layout"], "layout")
    assert (s.m, s.l_ev, got.l_ev) == (t["m"], t["l_ev"], t["l_ev"])
    assert _cells(s.tile_col_len, s.m) == _cells(t["tile_col_len"], t["m"])


def _stage_case(name):
    """A case of CASES, or one of the staged path's own: lower-case bases
    (every other read), reads past 832 bases (between 833 and 1000, with
    N bases)."""
    if name in CASES:
        return _case(**CASES[name])
    if name == "lower_case":
        graphs, rpp = _case(seed=6, n_frac=0.1)
        return graphs, [[r.lower() if i % 2 else r for i, r in enumerate(rs)]
                        for rs in rpp]
    rng = random.Random(9)
    graphs, rpp = _case(seed=9, n_pairs=3)
    rpp[1] = rpp[1] + ["".join(rng.choice("ACGTN") for _ in range(
        rng.randint(833, 1000))) for _ in range(3)]
    return graphs, rpp


def _pair_forms(rpp, form):
    """The pairs as read-string lists, as (blob, lens) tuples, or mixed
    (every other pair a tuple)."""
    if form == "lists":
        return rpp
    return [msw.pair_norm(r) if form == "blobs" or j % 2 else r
            for j, r in enumerate(rpp)]


@pytest.mark.parametrize("form", ["lists", "blobs", "mixed"])
@pytest.mark.parametrize("name", sorted(CASES) + ["long_reads",
                                                  "lower_case"])
def test_staged_tables_match_host_tables(name, form):
    graphs, rpp = _stage_case(name)
    a, jax_a = _multi(graphs)
    _assert_staged_matches(a, _pair_forms(rpp, form), jax_a)


def test_staged_pad_tile_of_a_dispatch_without_reads():
    graphs, _ = _case(seed=5, n_pairs=3)
    a, jax_a = _multi(graphs)
    rpp = [[], (b"", np.zeros(0, np.int32)), []]
    s = msw.stage_pair_tables(a, rpp, msw.TILE_LANES)
    assert (s.T, s.Bb, s.m, s.blob) == (1, 1, 32, b"A")
    assert s.layout == [([0, 0, 0, 0], 0)] * 3
    _assert_staged_matches(a, rpp, jax_a)


def test_staged_tables_refuse_bytes_that_disagree_with_lens():
    graphs, _ = _case(seed=5, n_pairs=2)
    a, _ = _multi(graphs)
    with pytest.raises(ValueError, match="read bytes"):
        msw.stage_pair_tables(a, [(b"ACGTA", [2, 2]), ["ACG"]],
                              msw.TILE_LANES)


@pytest.mark.parametrize("n_reads,dtype", [(32767, np.int16),
                                           (32768, np.int32)])
def test_col_idx_int16_int32_switch(n_reads, dtype):
    graphs, _ = _case(seed=7, n_pairs=2)
    rng = np.random.RandomState(7)
    lens = rng.randint(6, 12, size=n_reads).astype(np.int32)
    blob = rng.choice(list(b"ACGTN"), size=int(lens.sum())).astype(
        np.uint8).tobytes()
    half = n_reads // 2
    rpp = [(blob[:int(lens[:half].sum())], lens[:half]),
           (blob[int(lens[:half].sum()):], lens[half:])]
    got_a, want_a = _multi(graphs)
    got = msw.build_pair_tables(got_a, rpp, 128)
    want = jax_msw.build_pair_tables(want_a, rpp, 128)
    assert got["col_idx"].dtype == want["col_idx"].dtype == dtype
    _assert_tables_match(got, want, _n_tiles(rpp))
    _assert_staged_matches(got_a, rpp)


@pytest.mark.parametrize("read_len,fits", [(2000, True), (4000, False)])
def test_pack_bits_overflow_refused_by_both(read_len, fits):
    """A read of 4000 bases needs 12 row bits; with 8 or more column bits
    the score no longer fits the packed end-cell word."""
    graphs, rpp = _case(seed=8, n_pairs=2)
    rpp[0] = rpp[0] + ["ACGT" * (read_len // 4)]
    got_a, want_a = _multi(graphs)
    if fits:
        _assert_tables_match(msw.build_pair_tables(got_a, rpp, 128),
                             jax_msw.build_pair_tables(want_a, rpp, 128),
                             _n_tiles(rpp))
        _assert_staged_matches(got_a, rpp)
        return
    with pytest.raises(AssertionError):
        jax_msw.build_pair_tables(want_a, rpp, 128)
    with pytest.raises(ValueError, match="overflow"):
        msw.build_pair_tables(got_a, rpp, 128)
    with pytest.raises(ValueError, match="overflow"):
        msw.stage_pair_tables(got_a, rpp, 128)


@pytest.mark.parametrize("name", sorted(CASES))
def test_slice_pair_outputs_match(name):
    graphs, rpp = _case(**CASES[name])
    got_a, want_a = _multi(graphs)
    t = jax_msw.build_pair_tables(want_a, rpp, 128)
    B = len(t["col_idx"])
    rng = np.random.RandomState(9)
    vals = np.stack([
        rng.randint(0, 50, B),
        np.where(rng.rand(B) < 0.2, -1,
                 rng.randint(0, sum(want_a.col_len), B)),
        rng.randint(0, 60, B), rng.randint(0, 2, B)]).astype(np.int32)
    got, want = [None] * len(rpp), [None] * len(rpp)
    msw.slice_pair_outputs(got_a, vals, t["layout"], range(len(rpp)), got)
    jax_msw.slice_pair_outputs(want_a, vals, t["layout"], range(len(rpp)),
                               want)
    _assert_same(got, want, "results")


@pytest.mark.parametrize("reads", [
    [], ["ACGT", "acgtn", "A" * 150], ("ACGTAC".encode(), [2, 4])])
def test_pair_helpers_match(reads):
    for fn in ("pair_count", "pair_max_len"):
        assert getattr(msw, fn)(reads) == getattr(jax_msw, fn)(reads)
    _assert_same(msw.pair_norm(reads)[1], jax_msw.pair_norm(reads)[1])
    assert msw.pair_norm(reads)[0] == jax_msw.pair_norm(reads)[0]
    for n in (0, 1, 63, 64, 65, 300):
        assert msw.pair_tiles(n, 128) == jax_msw.pair_tiles(n, 128)
