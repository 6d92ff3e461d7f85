"""The port's multi-event fill on expanded reads (K2) vs the JAX package.

multi_fill_reference (the plain PyTorch fill, the CPU engine and the
CUDA kernel's oracle) against the TPU kernel multi_pallas_fill run in
interpret mode on identical tables; the port's MultiGraphSW against the
JAX MultiGraphSW on the cases of tests/test_multi_sw.py and
tests/test_paired_sw.py, chunked and not; and the MultiGraphArrays
keyword arguments against the JAX builder. Integer DP outputs: equality
is exact.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paragraph_tpu.ops import batched_sw as jax_bsw
from paragraph_tpu.ops import multi_sw as jax_msw
from paragraph_tpu_torch.align.graph_aligner import reverse_complement
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw

from test_gssw_vs_reference import _random_graph, _read_from_graph
from torch_twins import jax_graphs

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


def _events(seed, n_events=3, max_nodes=5, max_len=20, n_reads=(1, 4),
            read_lens=(6, 25), empty_every=0):
    rng = random.Random(seed)
    graphs, rpe = [], []
    for k in range(n_events):
        seqs, edges = _random_graph(rng, max_nodes=max_nodes,
                                    max_len=max_len)
        graphs.append(_make_graph(seqs, edges))
        if empty_every and k % empty_every == 0:
            rpe.append([])
            continue
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(*read_lens))
                 for _ in range(rng.randint(*n_reads))]
        rpe.append([r for r in reads if r])
    return graphs, rpe


def _legacy_cases():
    """The event batches of tests/test_multi_sw.py and
    tests/test_paired_sw.py (the latter as MultiGraphSW sees them: every
    pair expanded on the host into its two graphs and two read sets)."""
    out = {}
    rng = random.Random(808)
    graphs, rpe = [], []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=20)
        graphs.append(_make_graph(seqs, edges))
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(8, 25))
                 for _ in range(3)]
        rpe.append([r for r in reads if r])
    out["multi_808"] = (graphs, rpe)

    def expand(pairs):
        graphs, rpe = [], []
        for g, reads in pairs:
            fwd = [r.upper() for r in reads]
            rc = [reverse_complement(r) for r in fwd]
            graphs.extend([g, g.reversed()])
            rpe.append(fwd + rc)
            rpe.append([b[::-1] for b in fwd] + [b[::-1] for b in rc])
        return graphs, rpe

    rng = random.Random(909)
    pairs = []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=20)
        reads = [_read_from_graph(rng, seqs, edges,
                                  read_len=rng.randint(6, 25))
                 for _ in range(4)]
        pairs.append((_make_graph(seqs, edges), [r for r in reads if r]))
    out["paired_909"] = expand(pairs)
    rng = random.Random(910)
    pairs = []
    for _ in range(4):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=16)
        r = _read_from_graph(rng, seqs, edges, read_len=10)
        pairs.append((_make_graph(seqs, edges), [r] if r else ["ACGTACGT"]))
    out["paired_910"] = expand(pairs)
    out["empty_events"] = _events(seed=31, n_events=5, empty_every=2)
    out["mixed_lengths"] = _events(seed=32, n_events=3, max_len=60,
                                   n_reads=(5, 40), read_lens=(6, 150))
    return out


CASES = _legacy_cases()


def _assert_events_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for name, x, y in zip(FIELDS, g, w):
            assert x.dtype == y.dtype, (k, name)
            np.testing.assert_array_equal(x, y, err_msg=f"{k} {name}")


@pytest.mark.parametrize("col_budget", [msw.MultiGraphSW.COL_BUDGET, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_scorer_matches_jax_scorer(name, col_budget):
    graphs, rpe = CASES[name]
    sw = msw.MultiGraphSW(graphs, device="cpu", col_budget=col_budget)
    if col_budget == 64:
        assert len(sw.chunk_events) > 1
    got = sw.score(rpe)
    want = jax_msw.MultiGraphSW(jax_graphs(graphs), interpret=True,
                                col_budget=col_budget).score(rpe)
    _assert_events_equal(got, want)


def _host_tables(graphs, rpe, tb=32):
    """JAX builder arrays and expanded codes of one launch, as MultiGraphSW
    lays them out (without the power-of-two tile bucket)."""
    a = jax_msw.MultiGraphArrays(jax_graphs(graphs))
    reads, tile_event = [], []
    for ev, rs in enumerate(rpe):
        n_pad = -(max(1, len(rs)) // -tb) * tb
        reads.extend(rs + ["A"] * (n_pad - len(rs)))
        tile_event.extend([ev] * (n_pad // tb))
    max_len = max(len(r) for r in reads)
    codes, lens, vlens = jax_bsw.encode_reads(reads, -(max_len // -32) * 32)
    tile_event = np.asarray(tile_event, np.int32)
    t = {"tile_event": tile_event,
         "tile_col_start": np.asarray(a.col_start, np.int32)[tile_event],
         "tile_col_len": np.asarray(a.col_len, np.int32)[tile_event],
         "codes_t": codes.T.astype(np.int8), "lens": lens[None, :],
         "vlens": vlens[None, :],
         "l_ev": -(max(a.col_len) // -256) * 256}
    return a, t


@pytest.mark.parametrize("name", ["multi_808", "empty_events",
                                  "mixed_lengths"])
def test_reference_fill_matches_pallas_kernel(name):
    a, t = _host_tables(*CASES[name])
    want = np.asarray(jax_msw.multi_pallas_fill(
        jnp.asarray(a.packed_cols), jnp.asarray(a.pred_tables),
        *(jnp.asarray(t[k]) for k in ("tile_col_start", "tile_col_len",
                                      "tile_event", "codes_t", "lens",
                                      "vlens")),
        L=len(a.ref_codes), L_ev=t["l_ev"], N=a.n_max, P=a.p_max,
        M=t["codes_t"].shape[0], TB=32, interpret=True))
    tables = msw.MultiFillTables(
        *msw.graph_tensors(a, torch.device("cpu")),
        **{k: torch.from_numpy(np.ascontiguousarray(t[k])) for k in (
            "tile_col_start", "tile_col_len", "tile_event")},
        read_codes_t=torch.from_numpy(t["codes_t"]),
        lens=torch.from_numpy(t["lens"]),
        vlens=torch.from_numpy(t["vlens"]), l_ev=t["l_ev"])
    before = msw.multi_fill.launches
    got = msw.multi_fill(tables)
    assert msw.multi_fill.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(msw.multi_fill_reference(tables).numpy(),
                                  want)


@pytest.mark.parametrize("kwargs", [
    {}, {"n_max": 16}, {"p_max": 6}, {"l_to": 4096}, {"e_to": 9},
    {"n_max": 12, "p_max": 4, "l_to": 3000, "e_to": 7}])
def test_multi_graph_arrays_keywords_match_jax_builder(kwargs):
    graphs, _ = CASES["multi_808"]
    got = msw.MultiGraphArrays(graphs, **kwargs)
    want = jax_msw.MultiGraphArrays(jax_graphs(graphs), **kwargs)
    for attr in ("n_max", "p_max", "col_len", "col_start"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ("ref_codes", "col_node", "col_in_node", "is_start",
                 "is_last", "packed_cols", "pred_tables"):
        x, y = getattr(got, attr), getattr(want, attr)
        assert x.dtype == y.dtype and x.shape == y.shape, attr
        np.testing.assert_array_equal(x, y, err_msg=attr)


def test_scorer_refuses_odd_tile_batch_and_missing_card():
    graphs, _ = CASES["multi_808"]
    with pytest.raises(ValueError):
        msw.MultiGraphSW(graphs, tile_batch=48, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            msw.MultiGraphSW(graphs, device="cuda")
