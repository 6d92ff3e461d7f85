"""The port's kernel benchmark ablation (K4) vs the JAX harness.

kbench_fill_reference (the plain PyTorch version of every variant, the
CPU engine and the CUDA kernel's oracle in chip_smoke.py) against the
JAX tools/kbench2.py build_fill of the same variant, run in interpret
mode on the unpacked column streams of the same graph, reads and read
rows (the --m rule); the exact variants against the port's
multi_fill_reference; the unroll variants' refusal of an odd column
count; and the tools' command lines on the CPU. Integer DP outputs:
equality is exact.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paragraph_tpu.ops import multi_sw as jax_msw
from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.tools import kbench, kbench2

from torch_twins import jax_graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_RULE = 40      # --m: read rows max(40, bucket(READ_LEN, 8)) = 40
READ_LEN = 20


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


def _jax_kbench2():
    spec = importlib.util.spec_from_file_location(
        "jax_kbench2", os.path.join(ROOT, "tools", "kbench2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph_and_reads(seed=5, n_reads=30):
    """A four-node bubble graph (two alleles between two flanks) and reads
    of about READ_LEN bases from its two paths with substitutions, N bases
    and one- or two-base insertions and deletions."""
    rng = np.random.RandomState(seed)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.randint(0, 4, n))

    seqs = [seq(30), seq(20), seq(25), seq(30)]
    g = SequenceGraph(["LF", "A1", "A2", "RF"], seqs)
    for f, t in [(0, 1), (0, 2), (1, 3), (2, 3), (1, 2)]:
        g.add_edge(f, t)
    paths = [seqs[0] + seqs[1] + seqs[3], seqs[0] + seqs[2] + seqs[3],
             seqs[0] + seqs[1] + seqs[2] + seqs[3]]
    reads = []
    for i in range(n_reads):
        src = paths[i % 3]
        start = rng.randint(0, len(src) - READ_LEN)
        read = list(src[start:start + READ_LEN])
        j = 0
        while j < len(read):
            r = rng.random_sample()
            if r < 0.05:
                read[j] = "ACGTN"[rng.randint(0, 5)]
            elif r < 0.09:
                read.insert(j, seq(rng.randint(1, 3)))
                j += 1
            elif r < 0.13:
                del read[j:j + rng.randint(1, 3)]
                continue
            j += 1
        reads.append("".join(read))
    return g, reads


def _jax_expand(t):
    """The JAX harness's orientation expansion (its --check path), in
    numpy: codes int32 [M, B], lens / vlens [1, B]."""
    ci = t["col_idx"].astype(np.int64)
    codes = t["codes_t"].astype(np.int32)[:, ci]
    lens = t["lens"][0, ci]
    vlens = t["vlens"][0, ci]
    jj = np.arange(codes.shape[0])[:, None]
    flipped = np.take_along_axis(
        codes, np.where(jj < lens, lens - 1 - jj, jj), 0)
    x = np.where(t["flip"] != 0, flipped, codes)
    x = np.where((t["comp"] != 0) & (x < 4), 3 - x, x)
    return x.astype(np.int32), lens[None, :], vlens[None, :]


@pytest.fixture(scope="module")
def case():
    """(port tables, JAX arrays, JAX tables) of one paired dispatch: two
    tiles of 128 lanes (the graph and its reversal), 128 columns each."""
    g, reads = _graph_and_reads()
    pairs = [g, g.reversed()]
    a = msw.MultiGraphArrays(pairs)
    host = msw.build_pair_tables(a, [reads], msw.TILE_LANES)
    rows = max(kbench2.rows_for(M_RULE, READ_LEN), host["m"])
    tables = kbench2.expanded_tables(
        msw.tables_from_numpy(host, a, "cpu"), rows)
    jax_a = jax_msw.MultiGraphArrays(jax_graphs(pairs))
    pad_to = max(M_RULE, jax_msw._bucket(READ_LEN, 8))
    jax_t = jax_msw.build_pair_tables(jax_a, [reads], 128, pad_to)
    assert tables.read_codes_t.shape[0] == jax_t["m"] == M_RULE
    assert tables.tile_event.shape[0] == 2
    assert tables.tile_col_len.tolist() == [128, 128]
    return tables, jax_a, jax_t


@pytest.fixture(scope="module")
def jax_outputs(case):
    """Every variant's [4, B] output from the JAX harness, computed once."""
    _, a, t = case
    kb = _jax_kbench2()
    x, lens, vlens = _jax_expand(t)
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, kw in kb.VARIANTS.items():
            fill = kb.build_fill(kw, L=len(a.ref_codes), L_ev=t["l_ev"],
                                 N=a.n_max, P=a.p_max, M=t["m"], TB=128)
            out[name] = np.asarray(fill(
                a.ref_codes, a.col_node, a.col_in_node, a.is_start,
                a.is_last, a.pred_tables, t["tile_col_start"],
                t["tile_col_len"], t["tile_event"], x, lens, vlens))
    return out


@pytest.mark.parametrize("name", list(kbench2.VARIANTS))
def test_reference_matches_jax_harness(name, case, jax_outputs):
    tables = case[0]
    before = kbench2.kbench_fill.launches
    got = kbench2.kbench_fill(tables, name)
    assert kbench2.kbench_fill.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_outputs[name])


@pytest.mark.parametrize("name", list(kbench2.VARIANTS))
def test_warp_layout_matches_jax_harness(name, case, jax_outputs):
    """The CUDA kernel's warp-per-lane decomposition of each variant
    (emulated in tests/test_torch_kbench_warp.py) == the JAX harness."""
    from test_torch_kbench_warp import kbench_warp_fill

    got = kbench_warp_fill(case[0], name)
    np.testing.assert_array_equal(got.numpy(), jax_outputs[name])


@pytest.mark.parametrize("name", kbench2.EXACT)
def test_exact_variants_are_the_multi_event_fill(name, case):
    tables = case[0]
    assert torch.equal(kbench2.kbench_fill_reference(tables, name),
                       msw.multi_fill_reference(tables))


def test_each_inexact_variant_differs_from_v0(case, jax_outputs):
    """The indels make F win somewhere, and the bubble gives nodes to
    seed and save: every functional switch changes the outputs."""
    want = jax_outputs["v0"]
    for name in set(kbench2.VARIANTS) - set(kbench2.EXACT):
        got = kbench2.kbench_fill_reference(case[0], name).numpy()
        assert not np.array_equal(got, want), name
    notrack = kbench2.kbench_fill_reference(case[0], "notrack")
    assert (notrack[0] == 0).all() and (notrack[1] == -1).all()
    assert (notrack[2] == 0).all()


@pytest.mark.parametrize("name", ["unroll2", "hoist_u2"])
def test_odd_column_count_raises_for_unroll_variants(name, case):
    tables = case[0]
    odd = dataclasses.replace(tables, tile_col_len=tables.tile_col_len - 1)
    for fn in (kbench2.kbench_fill, kbench2.kbench_fill_reference):
        with pytest.raises(ValueError, match="multiple"):
            fn(odd, name)
    assert kbench2.kbench_fill_reference(odd, "v0").shape == (4, 256)


def test_variants_match_the_jax_harness():
    kb = _jax_kbench2()
    assert list(kbench2.VARIANTS) == list(kb.VARIANTS)
    assert kbench2.VARIANTS == kb.VARIANTS
    assert {kbench2.tpu_body(v) for v in kbench2.VARIANTS} == {
        "make_kernel", "make_kernel_opt", "make_kernel_opt2"}
    with pytest.raises(ValueError, match="unknown variant"):
        kbench2.kbench_fill_reference(None, "v9")


def test_kernel_needs_cuda_device(case):
    tables = case[0]
    meta = dataclasses.replace(
        tables, packed_cols=tables.packed_cols.to("meta"))
    with pytest.raises(ValueError):
        kbench2.kbench_fill(meta, "v0")


def test_bench_case_matches_the_jax_bench():
    """kbench's case is bench.py's build_case: the same graph and reads."""
    import bench

    want_g, want_reads = bench.build_case(read_len=30, n_reads=16)
    got_g, got_reads = kbench.build_case(read_len=30, n_reads=16)
    assert got_reads == want_reads
    assert got_g.node_seqs == want_g.node_seqs
    assert got_g.edges() == want_g.edges()


def test_kbench2_command_line_on_cpu(capsys):
    assert kbench2.main(["--device", "cpu", "--reads", "2", "--readlen",
                         "20", "--m", "24", "--k", "2", "--variants",
                         "v0,nof"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and sorted(out["variants"]) == ["nof",
                                                                  "v0"]
    assert kbench2.main(["--device", "cpu", "--reads", "2", "--readlen",
                         "20", "--m", "24", "--k", "1", "--check",
                         "--variants", "v0,hoist,nof"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["check v0: EXACT", "check hoist: EXACT",
                     "check nof: EXACT"]


def test_kbench_command_line_on_cpu(capsys):
    assert kbench.main(["--device", "cpu", "--reads", "2", "--iters",
                        "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["cells"] == 2 * 640 * 128 * 160
    assert set(out) == {"single_dispatch_s", "queued_per_dispatch_s",
                        "cells", "gcells_single", "gcells_queued", "device"}
