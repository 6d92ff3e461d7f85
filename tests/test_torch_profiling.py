"""The port's spans and counters (``utils/profiling.py``), on the CPU.

- ``span`` adds a block's seconds into its stats dict, and with no
  profiler running opens no profiler event;
- under a CPU ``torch.profiler`` it puts ``paragraph:<name>`` events on
  the host timeline, nested as the code nests, as function-scope records
  (no user annotation, so nothing of them is copied onto a device
  timeline), with the dispatch's serial after ``#``;
- the scorers' counters: ``PairedGraphSW``, ``ShardedPairedSW`` and
  ``SingleGraphSW`` keep the one key set, and every dispatch shows as
  its five spans under one serial;
- off a card every paired fetch finds its output ready (``fetch_ready``),
  and rounds finalised one behind the next dispatch, as the benchmark's
  realign loop and the pipeline run them, give ``score_pairs``' outputs;
- off a card no dispatch builds its read tables on a card
  (``tables_on_card`` 0);
- ``timing_events`` and ``kernel_seconds`` off a card;
- ``pipeline_stage`` adds into ``stage_s`` under a ``pipeline.<key>``
  span.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from paragraph_tpu_torch.graph.model import SequenceGraph
from paragraph_tpu_torch.ops import multi_sw as msw
from paragraph_tpu_torch.ops import pallas_sw as psw
from paragraph_tpu_torch.parallel.distributed import ShardedPairedSW
from paragraph_tpu_torch.pipeline.parallel_grmpy import pipeline_stage
from paragraph_tpu_torch.utils import profiling
from paragraph_tpu_torch.utils.profiling import (SPAN_PREFIX, kernel_seconds,
                                                 span, timing_events)

CPU = torch.device("cpu")
SCORER_SPANS = ["scorer.tables", "scorer.put", "scorer.launch",
                "scorer.fetch", "scorer.slice"]
SCORER_KEYS = {"dispatches", "cells", "tables_s", "put_s", "call_s",
               "device_wait_s", "slice_s", "k1_s", "fetch_ready",
               "tables_on_card"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seq="ACGTTGCAAC", alt="GGT"):
    g = SequenceGraph(["left", "alt", "right"], [seq, alt, seq[::-1]])
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(0, 2)
    return g


def _reads():
    return ["ACGTTGCAACGGTCAACG", "TTGCAACCAACGTTGCA", "ACGTTGCA"]


def _program_events(prof):
    """(start, end, name) of the trace's paragraph: events, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(SPAN_PREFIX):
            start = e.start_ns()
            out.append((start, start + e.duration_ns(),
                        e.name()[len(SPAN_PREFIX):], e))
    return sorted(out, key=lambda x: x[0])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _program_events(prof)


def test_span_adds_seconds_and_opens_no_event_without_a_profiler(
        monkeypatch):
    opened = []
    profiling._bind_torch()
    monkeypatch.setattr(profiling, "_event_scope",
                        lambda name: opened.append(name))
    stats = {"tables_s": 1.0}
    with span("scorer.tables", stats, "tables_s", serial=3):
        sum(range(1000))
    with span("scorer.put", stats, "put_s"):
        pass
    with span("untimed"):
        pass
    assert stats["tables_s"] > 1.0 and stats["put_s"] >= 0.0
    assert set(stats) == {"tables_s", "put_s"}
    assert opened == []


def test_span_nests_on_the_host_timeline_under_a_profiler():
    stats = {}

    def body():
        with span("outer", stats, "outer_s"):
            with span("inner", stats, "inner_s", serial=7):
                torch.ones(4).sum()
            with span("second"):
                pass

    events = _traced(body)
    assert [n for _, _, n, _ in events] == ["outer", "inner#7", "second"]
    (o0, o1, _, _), (i0, i1, _, _), (s0, s1, _, _) = events
    assert o0 <= i0 < i1 <= s0 < s1 <= o1
    # function-scope records: the profiler copies no user annotation of
    # them onto a device's timeline
    assert not any(e.is_user_annotation() for *_, e in events)
    assert stats["outer_s"] >= stats["inner_s"] > 0


def test_the_three_scorers_keep_one_key_set():
    graphs = [_graph(), _graph("TTGACCGTAA", "C")]
    rpp = [_reads(), _reads()[:2]]
    paired = msw.PairedGraphSW(graphs, device="cpu")
    sharded = ShardedPairedSW(graphs, mesh=[CPU] * 2, col_budget=1)
    single = psw.SingleGraphSW(graphs[0], device="cpu")
    paired.score_pairs(rpp)
    sharded.score_pairs(rpp)
    single.score(_reads())
    for sw in (paired, sharded, single):
        assert set(sw.stats) == SCORER_KEYS == set(msw.scorer_stats())
        assert sw.stats["k1_s"] == 0.0  # no card
        assert sw.stats["slice_s"] > 0
    assert sharded.stats["dispatches"] == 2
    assert set(sharded.engine_report()) == SCORER_KEYS | {"cells_per_k1_s"}


@pytest.mark.parametrize("scorer", ["paired", "sharded", "single"])
def test_each_dispatch_shows_as_five_spans_under_one_serial(scorer):
    graphs = [_graph(), _graph("TTGACCGTAA", "C")]
    if scorer == "paired":
        sw = msw.PairedGraphSW(graphs, device="cpu")
        run = lambda: sw.score_pairs([_reads(), _reads()])  # noqa: E731
    elif scorer == "sharded":
        sw = ShardedPairedSW(graphs, mesh=[CPU] * 2, col_budget=1)
        run = lambda: sw.score_pairs([_reads(), _reads()])  # noqa: E731
    else:
        sw = psw.SingleGraphSW(graphs[0], device="cpu")
        run = lambda: sw.finalize(sw.score_device(_reads()))  # noqa: E731
    events = _traced(run)
    by_serial = {}
    for _, _, name, _ in events:
        base, serial = name.split("#")
        by_serial.setdefault(int(serial), []).append(base)
    assert len(by_serial) == sw.stats["dispatches"]
    serials = sorted(by_serial)
    assert serials == list(range(serials[0], serials[0] + len(serials)))
    for names in by_serial.values():
        assert sorted(names) == sorted(SCORER_SPANS)
    # every launch is issued before the first fetch
    order = [name.split("#")[0] for _, _, name, _ in events]
    assert max(i for i, n in enumerate(order) if n == "scorer.launch") \
        < min(i for i, n in enumerate(order) if n == "scorer.fetch")


def _scorer(kind, graphs):
    if kind == "paired":
        return msw.PairedGraphSW(graphs, device="cpu")
    return ShardedPairedSW(graphs, mesh=[CPU] * 2, col_budget=1)


def test_fetch_ready_counts_every_paired_fetch_off_a_card():
    graphs = [_graph(), _graph("TTGACCGTAA", "C")]
    rpp = [_reads(), _reads()[:2]]
    single = psw.SingleGraphSW(graphs[0], device="cpu")
    single.score(_reads())
    single.finalize(single.score_device(_reads()[:1]))
    assert single.stats["dispatches"] > 0 and single.stats["fetch_ready"] == 0
    for kind in ("paired", "sharded"):
        sw = _scorer(kind, graphs)
        sw.score_pairs(rpp)
        sw.finalize_pairs(sw.score_pairs_device(rpp[::-1]))
        assert sw.stats["fetch_ready"] == sw.stats["dispatches"] \
            == (2 if kind == "paired" else 4)


@pytest.mark.parametrize("kind", ["paired", "sharded"])
def test_rounds_finalised_behind_the_next_dispatch_match(kind):
    graphs = [_graph(), _graph("TTGACCGTAA", "C"), _graph("GATTACAGAT", "T")]
    rounds = [[_reads(), _reads()[:2], _reads()[1:]],
              [_reads()[:1], [], _reads()],
              [_reads()[::-1], _reads()[2:], _reads()[:2]]]
    sw = _scorer(kind, graphs)
    want = [_scorer(kind, graphs).score_pairs(rpp) for rpp in rounds]
    got = []
    pending = sw.score_pairs_device(rounds[0])
    for rpp in rounds[1:]:
        handle = sw.score_pairs_device(rpp)
        got.append(sw.finalize_pairs(pending))
        pending = handle
    got.append(sw.finalize_pairs(pending))
    for g_round, w_round in zip(got, want):
        for g, w in zip(g_round, w_round):
            for side in range(2):
                for x, y in zip(g[side], w[side]):
                    assert x.dtype == y.dtype
                    assert (x == y).all()
    assert sw.stats["fetch_ready"] == sw.stats["dispatches"]


def test_tables_on_card_is_zero_off_a_card():
    graphs = [_graph(), _graph("TTGACCGTAA", "C")]
    rpp = [_reads(), _reads()[:2]]
    single = psw.SingleGraphSW(graphs[0], device="cpu")
    single.score(_reads())
    for sw in (_scorer("paired", graphs), _scorer("sharded", graphs)):
        sw.score_pairs(rpp)
        sw.finalize_pairs(sw.score_pairs_device(rpp[::-1]))
        assert sw.stats["dispatches"] > 0
        assert sw.stats["tables_on_card"] == 0
        assert sw.engine_report()["tables_on_card"] == 0
    assert single.stats["dispatches"] > 0
    assert single.stats["tables_on_card"] == 0


def test_timing_events_are_none_off_a_card():
    pair = timing_events(CPU)
    assert pair is None
    assert kernel_seconds(CPU, pair) == 0.0


def test_pipeline_stage_adds_into_stage_s():
    stats = {"dispatches": 1}

    def body():
        with pipeline_stage(stats, "load"):
            pass
        with pipeline_stage(stats, "load"):
            pass
        with pipeline_stage(stats, "write_json"):
            pass

    events = _traced(body)
    assert [n for _, _, n, _ in events] == ["pipeline.load"] * 2 + [
        "pipeline.write_json"]
    assert set(stats["stage_s"]) == {"load", "write_json"}
    assert stats["dispatches"] == 1
