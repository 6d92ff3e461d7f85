"""The reading of the program's spans (``program_spans.py``) and the
metrics on it, on synthetic profiler events: two rounds worked by hand.

Times in ms (events in ns). The window is [0, 100]. Round 1 (dispatch
1): tables [0, 20], put [20, 25] (its copy on the card [21, 23]), launch
[25, 27], K1 on the card [26, 56]. Round 2 (dispatch 2): tables [27,
47], put [47, 50] (copy [48, 49]), launch [50, 52], K1 [56, 86], queued
behind round 1's. Fetch of dispatch 1 [52, 88]: its copy out [86, 87]
waits behind round 2's K1; slice [88, 92]; fetch of 2 [92, 95] (copy
[93, 94]); slice [95, 98].

Busy [21, 23], [26, 87], [93, 94]: idle 36 ms, of which tables 20, put
3 ([20, 21], [23, 25]), launch 1, fetch 3, slice 7, outside 2. Fetch
time 39 ms, of which 30 with round 2's K1 on the card, 4 with its own.
"""
import pytest
from torch.autograd import DeviceType

from benchmark import program_spans, trace
from benchmark.cells import load_reader

MS = 1_000_000


class Event:
    def __init__(self, name, a, b, cuda=False, corr=0):
        self._name, self._a, self._b = name, int(a * MS), int(b * MS)
        self._cuda, self._corr = cuda, corr

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._corr


K1 = "void paired_sw_kernel<5, true>"


def card_events(launch_calls=True):
    """The benchmark's window and the card's work (no program span), with
    the host's runtime launch calls of the two K1s when `launch_calls`."""
    out = [Event("bench:window", 0, 100),
           Event("bench:score_pairs_device round 0", 0, 27),
           Event("bench:score_pairs_device round 0", 26, 56, cuda=True),
           Event("Memcpy HtoD (Pinned -> Device)", 21, 23, cuda=True),
           Event(K1, 26, 56, cuda=True, corr=101),
           Event("Memcpy HtoD (Pinned -> Device)", 48, 49, cuda=True),
           Event(K1, 56, 86, cuda=True, corr=102),
           Event("Memcpy DtoH (Device -> Pageable)", 86, 87, cuda=True),
           Event("Memcpy DtoH (Device -> Pageable)", 93, 94, cuda=True)]
    if launch_calls:
        out += [Event("cudaLaunchKernel", 26, 26.5, corr=101),
                Event("cudaLaunchKernel", 51, 51.5, corr=102)]
    return out


def program_events():
    """The program's spans of the two rounds, on the host timeline."""
    spans = [("scorer.tables#1", 0, 20), ("scorer.put#1", 20, 25),
             ("scorer.launch#1", 25, 27), ("scorer.tables#2", 27, 47),
             ("scorer.put#2", 47, 50), ("scorer.launch#2", 50, 52),
             ("scorer.fetch#1", 52, 88), ("scorer.slice#1", 88, 92),
             ("scorer.fetch#2", 92, 95), ("scorer.slice#2", 95, 98)]
    return [Event("paragraph:" + n, a, b) for n, a, b in spans]


def test_summarize_is_unchanged_by_the_programs_spans():
    plain = trace.summarize(card_events())
    with_spans = trace.summarize(card_events() + program_events())
    assert with_spans == plain
    assert plain["busy_s"] == pytest.approx(0.064)


def test_idle_split_and_fetch_share_of_two_rounds():
    s = program_spans.summarize_program(card_events() + program_events())
    idle = {k: round(v * 1e3, 6) for k, v in s["idle_s"].items()}
    assert idle == {"scorer.tables": 20, "scorer.slice": 7,
                    "scorer.put": 3, "scorer.fetch": 3,
                    program_spans.OUTSIDE: 2, "scorer.launch": 1}
    assert s["idle_total_s"] == pytest.approx(0.036)
    # the split sums to the card's idle share over the window
    busy = trace.summarize(card_events())["busy_s"]
    assert sum(s["idle_s"].values()) == pytest.approx(s["window_s"] - busy)
    fetch = s["fetch"]
    assert fetch["kernels_joined"] == fetch["kernels"] == 2
    assert fetch["total_s"] == pytest.approx(0.039)
    assert fetch["behind_later_s"] == pytest.approx(0.030)
    assert fetch["own_s"] == pytest.approx(0.004)
    assert s["spans"]["scorer.tables"] == pytest.approx([2, 0.040, 0.040])
    assert s["longest_idle"][0][0] == pytest.approx(0.021)
    assert s["longest_idle"][0][1][0] == ["scorer.tables",
                                          pytest.approx(0.020)]
    assert s["device_annotations"] == 0


def test_kernels_without_a_launch_call_join_no_dispatch():
    s = program_spans.summarize_program(card_events(launch_calls=False)
                                        + program_events())
    assert s["fetch"] == {"spans": 2, "total_s": pytest.approx(0.039),
                          "kernels_joined": 0, "kernels": 2}


def test_nested_spans_give_self_time_to_the_innermost():
    events = [Event("bench:window", 0, 10),
              Event("paragraph:pipeline.score_dispatch", 0, 10),
              Event("paragraph:scorer.tables#1", 0, 4),
              Event("paragraph:scorer.put#1", 4, 6)]
    s = program_spans.summarize_program(events)
    assert s["spans"]["pipeline.score_dispatch"] == pytest.approx(
        [1, 0.010, 0.004])
    assert s["idle_s"] == pytest.approx({"scorer.tables": 0.004,
                                         "pipeline.score_dispatch": 0.004,
                                         "scorer.put": 0.002})
    assert "fetch" not in s


class Trace:
    """Stands for benchmark.trace.Trace on the caller's frame."""

    def __init__(self, events):
        kineto = type("K", (), {"events": lambda self: events})()
        profiler = type("P", (), {"kineto_results": kineto})()
        self.prof = type("Prof", (), {"profiler": profiler})()


def _read(metric, run):
    return load_reader(metric)(run)


def test_the_readers_on_the_two_rounds(capsys):
    tr = Trace(card_events() + program_events())  # noqa: F841 (read by
    # program_spans.of_run on this frame)
    run = {"window_s": 0.1, "trace": {"busy_s": 0.064},
           "scorer": {"dispatches": 2, "k1_s": 0.060}}
    assert _read("tables_idle_share.realign", run) == pytest.approx(20.0)
    assert _read("k1_ms_per_dispatch.realign", run) == pytest.approx(30.0)
    assert '"program_spans"' in capsys.readouterr().err


def test_the_readers_return_none_with_nothing_to_read():
    parent = {"window_s": 0.1, "trace": {"busy_s": 0.064},
              "scorer": {"dispatches": 2, "tables_s": 0.04, "put_s": 0.01}}
    untraced = {"window_s": 0.1, "trace": None, "scorer": {}}
    names = ("k1_ms_per_dispatch.realign", "tables_idle_share.realign")
    for run in (parent, untraced):
        # no profiler on the frames
        assert [_read(m, dict(run)) for m in names] == [None] * 2
    tr = Trace(card_events())  # noqa: F841 - a trace with no program span
    assert [_read(m, dict(parent)) for m in names] == [None] * 2
