"""The port's single-graph fill and scorer vs the JAX package.

graph_fill_reference (the plain PyTorch fill, the CPU engine and the
CUDA kernel's oracle) against the TPU kernel pallas_fill run in
interpret mode on identical tables, and the port's SingleGraphSW against
the JAX PallasGraphSW (interpret mode) and BatchedGraphSW (the scan). All
outputs are integer DP results: equality is exact. The CUDA kernel itself
is compared with the plain fill on the card in tests/test_torch_cuda.py.
"""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paragraph_tpu.ops import batched_sw as jax_bsw
from paragraph_tpu.ops import pallas_sw as jax_psw
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import pallas_sw as psw

from test_gssw_vs_reference import _random_graph, _read_from_graph
from torch_twins import jax_graph

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


def _case(seed, max_nodes=6, max_len=24, n_reads=(1, 12), read_lens=(6, 30),
          n_frac=0.0):
    rng = random.Random(seed)
    seqs, edges = _random_graph(rng, max_nodes=max_nodes, max_len=max_len)
    seqs = ["".join("N" if rng.random() < n_frac else c for c in s)
            for s in seqs]
    reads = [_read_from_graph(rng, seqs, edges,
                              read_len=rng.randint(*read_lens))
             for _ in range(rng.randint(*n_reads))]
    return _make_graph(seqs, edges), [r for r in reads if r] or ["ACGTAC"]


CASES = {
    "random": dict(seed=41),
    "n_bases": dict(seed=42, n_frac=0.15),
    "mixed_6_150": dict(seed=43, max_len=60, n_reads=(20, 40),
                        read_lens=(6, 150)),
    "longer_than_graph": dict(seed=44, max_nodes=3, max_len=6,
                              read_lens=(40, 90)),
    "single_read": dict(seed=45, n_reads=(1, 1)),
}


def _jax_fill(arrays, codes, lens, vlens, tb, match=1):
    out = jax_psw.pallas_fill(
        jnp.asarray(arrays.ref_codes), jnp.asarray(arrays.col_node),
        jnp.asarray(arrays.col_in_node),
        jnp.asarray(arrays.is_start.astype(np.int32)),
        jnp.asarray(arrays.is_last.astype(np.int32)),
        jnp.asarray(arrays.pred_table), jnp.asarray(codes.T.astype(np.int8)),
        jnp.asarray(lens[None, :]), jnp.asarray(vlens[None, :]),
        L=len(arrays.ref_codes), N=arrays.num_nodes,
        P=arrays.pred_table.shape[1], M=codes.shape[1], TB=tb, match=match,
        interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_fill_matches_pallas_kernel(name):
    g, reads = _case(**CASES[name])
    tb = 32
    n_pad = -(len(reads) // -tb) * tb
    padded = reads + ["A"] * (n_pad - len(reads))
    max_len = max(len(r) for r in padded)
    codes, lens, vlens = jax_bsw.encode_reads(padded,
                                              -(max_len // -32) * 32)
    arrays = jax_bsw.GraphArrays.build(jax_graph(g))
    want = _jax_fill(arrays, codes, lens, vlens, tb)
    tables = psw.graph_tables_from_numpy(arrays, codes.T, lens, vlens, "cpu")
    got = psw.graph_fill_reference(tables)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_equal(got, want, same_dtype=True):
    for name, x, y in zip(FIELDS, got, want):
        if same_dtype:
            assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _legacy_cases():
    """The graphs and reads of tests/test_pallas_sw.py."""
    out = {"u8_simple": (
        _make_graph(["AAAATTTT", "CCCC", "GGGGAAAA"],
                    [(0, 1), (0, 2), (1, 2)]),
        ["TTTTCCCCGGGG", "AAAATTTTGGGG", "CCCCGGGG", "TTTT", "GGGGGGGG",
         "ACGT"])}
    rng = random.Random(31337)
    for case in range(4):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=24)
        reads = []
        for _ in range(4):
            r = _read_from_graph(rng, seqs, edges,
                                 read_len=rng.randint(8, 30))
            if r:
                reads.append(r)
        if reads:
            out[f"u8_random_{case}"] = (_make_graph(seqs, edges), reads)
    return out


SCORER_CASES = {**_legacy_cases(),
                **{k: _case(**v) for k, v in CASES.items()}}


@pytest.mark.parametrize("tile_batch", [32, 128])
@pytest.mark.parametrize("name", sorted(SCORER_CASES))
def test_scorer_matches_jax_scorers(name, tile_batch):
    g, reads = SCORER_CASES[name]
    got = psw.SingleGraphSW(g, tile_batch=tile_batch,
                            device="cpu").score(reads)
    want = jax_psw.PallasGraphSW(jax_graph(g), tile_batch=tile_batch,
                                 interpret=True).score(reads)
    _assert_equal(got, want)
    # the scan returns the multi flag as bool; the values must agree
    _assert_equal(got, jax_bsw.BatchedGraphSW(jax_graph(g)).score(reads),
                  same_dtype=False)


def test_scores_that_overflow_the_packed_word():
    """With match=100000 the JAX scorer's packed end-cell word cannot hold
    the scores and it switches to the scan; the port's one fill has no
    packed word and gives the scan's outputs."""
    g, reads = _case(seed=46, max_nodes=3, max_len=12, read_lens=(6, 20))
    arrays = jax_bsw.GraphArrays.build(jax_graph(g))
    assert jax_psw.pack_bits(len(arrays.ref_codes), 32, 100000) is None
    got = psw.SingleGraphSW(g, match=100000, device="cpu").score(reads)
    want = jax_psw.PallasGraphSW(jax_graph(g), match=100000,
                                 interpret=True).score(reads)
    # the scan returns the multi flag as bool; the values must agree
    _assert_equal(got, want, same_dtype=False)
    assert want[4].dtype == bool and got[0].max() >= 100000


def test_zero_score_reads_flag_multi():
    """A lane with score 0 counts every node slot (filler nodes included)
    as attaining it, so multi = 1 when N > 1: the TPU kernel's quirk,
    reproduced."""
    g = _make_graph(["AAAAAA", "AAAA", "AAAAA"], [(0, 1), (0, 2), (1, 2)])
    reads = ["CCCCCC", "NNNN", "A", "CCAC"]
    got = psw.SingleGraphSW(g, device="cpu").score(reads)
    _assert_equal(got, jax_psw.PallasGraphSW(jax_graph(g),
                                             interpret=True).score(reads))
    score, end_node, end_ref, end_read, multi = got
    assert (score[:2] == 0).all() and (multi[:2] == 1).all()
    assert (end_ref[:2] == -1).all() and (end_read[:2] == 0).all()


def test_stats_carry_the_scorer_keys():
    g, reads = SCORER_CASES["u8_simple"]
    sw = psw.SingleGraphSW(g, device="cpu")
    hf = sw.score_device(reads)
    hr = sw.score_device(reads[:2])
    sw.finalize(hf)
    sw.finalize(hr)
    assert set(sw.stats) == {"dispatches", "cells", "lanes", "device_wait_s",
                             "dispatch_host_s", "tables_s", "put_s",
                             "call_s"}
    assert sw.stats["dispatches"] == 2
    assert sw.stats["lanes"] == 2 * psw.TILE_LANES
    assert sw.stats["cells"] == 2 * len(sw.arrays.ref_codes) \
        * psw.TILE_LANES * 32


def test_graph_fill_on_cpu_runs_the_plain_version():
    g, reads = _case(seed=47)
    codes, lens, vlens = jax_bsw.encode_reads(reads, 32)
    tables = psw.graph_tables_from_numpy(
        jax_bsw.GraphArrays.build(jax_graph(g)), codes.T, lens, vlens,
        "cpu")
    before = psw.graph_fill.launches
    got = psw.graph_fill(tables)
    assert psw.graph_fill.launches == before
    assert torch.equal(got, psw.graph_fill_reference(tables))
    meta = dataclasses.replace(tables, ref_codes=tables.ref_codes.to("meta"))
    with pytest.raises(ValueError):
        psw.graph_fill(meta)


def test_scorer_refuses_odd_tile_batch_and_missing_card():
    g, _ = _case(seed=48)
    with pytest.raises(ValueError):
        psw.SingleGraphSW(g, tile_batch=48, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            psw.SingleGraphSW(g, device="cuda")
