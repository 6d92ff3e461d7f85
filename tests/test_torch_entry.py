"""The port's entry points (graft_entry.py), profiling hook and host profiler.

- ``graft_entry.entry("cpu")``: K3's plain fill of the example graph's 64
  reads equals ``__graft_entry__.entry()``'s scan fill on the same graph
  and reads, field by field (the mapping is in the test);
- ``graft_entry.dryrun_multichip(4, wl, mesh=[cpu] * 4)`` passes on a
  small make_workload directory (its own checks: sharded == serial,
  merged edge counts, device engine's confident calls);
- ``utils/profiling.py::maybe_profile``: nothing without
  PARAGRAPH_TPU_PROFILE, a Chrome trace with it, the run's own errors
  untouched;
- ``tools/prof_host.py``: its main on a 4-event workload on the CPU, and
  the port's tools run by path from the repository's root.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax_batched_fill():
    """K3's [4, B] (score, end column, end row, multi) against the scan's
    (score, end node, end in-node offset, end read row, multi): end node
    and offset are the column's col_node and col_in_node, 0 and -1 where
    the score is 0 (end column -1)."""
    import __graft_entry__

    from paragraph_tpu_torch.graft_entry import entry
    from paragraph_tpu_torch.ops.batched_sw import GraphArrays
    from paragraph_tpu_torch.ops.pallas_sw import graph_fill_reference

    fn, args = entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    out = fn(*args).numpy()
    assert out.shape == (4, 64) and out.dtype == np.int32
    jfn, jargs = __graft_entry__.entry()
    score, end_node, end_ref, end_read, multi = (np.asarray(x)
                                                 for x in jfn(*jargs))
    from paragraph_tpu_torch.graft_entry import _example_graph

    arrays = GraphArrays.build(_example_graph())
    col = out[1]
    valid = col >= 0
    safe = np.where(valid, col, 0)
    np.testing.assert_array_equal(out[0], score)
    assert (score > 0).all()
    np.testing.assert_array_equal(
        np.where(valid, arrays.col_node[safe], 0), end_node)
    np.testing.assert_array_equal(
        np.where(valid, arrays.col_in_node[safe], -1), end_ref)
    np.testing.assert_array_equal(out[2], end_read)
    np.testing.assert_array_equal(out[3], multi.astype(np.int32))
    from paragraph_tpu_torch.ops.pallas_sw import GraphFillTables

    np.testing.assert_array_equal(
        graph_fill_reference(GraphFillTables(*args)).numpy(), out)


def test_entry_refuses_a_missing_card():
    from paragraph_tpu_torch.graft_entry import entry

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        entry("cuda")


@pytest.fixture(scope="module")
def workload8(tmp_path_factory):
    """An 8-event, 1-sample make_workload directory at 10x."""
    from make_workload import generate

    wl = str(tmp_path_factory.mktemp("wl_entry"))
    generate(wl, n_events=8, depth=10, seed=3)
    return wl


def test_dryrun_multichip_on_a_cpu_mesh(workload8):
    from paragraph_tpu_torch.graft_entry import dryrun_multichip
    from paragraph_tpu_torch.ops.multi_sw import paired_fill

    summary = dryrun_multichip(4, workload8, mesh=[torch.device("cpu")] * 4)
    assert summary["events"] == 8 and summary["samples"] == 1
    assert summary["confident_calls"] > 0
    with pytest.raises(ValueError, match="takes 10"):
        dryrun_multichip(5, workload8, mesh=[torch.device("cpu")] * 5)
    assert paired_fill.launches == 0  # the CPU runs the plain fill


def test_maybe_profile_is_off_without_the_variable(tmp_path, monkeypatch):
    from paragraph_tpu_torch.utils.profiling import ENV_VAR, maybe_profile

    monkeypatch.delenv(ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_profile("grmpy"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    from paragraph_tpu_torch.utils.profiling import ENV_VAR, maybe_profile

    monkeypatch.setenv(ENV_VAR, str(tmp_path))
    with maybe_profile("grmpy"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    traces = list((tmp_path / "grmpy").glob("*.pt.trace.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with pytest.raises(KeyError, match="the run's own"):
        with maybe_profile("failed"):
            raise KeyError("the run's own")
    assert len(list((tmp_path / "failed").glob("*.pt.trace.json"))) == 1


def test_maybe_profile_never_breaks_the_run(tmp_path, monkeypatch, caplog):
    """A profiler that cannot start costs one warning and no trace."""
    from paragraph_tpu_torch.utils.profiling import ENV_VAR, maybe_profile

    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv(ENV_VAR, str(blocker))  # makedirs under a file fails
    ran = []
    with maybe_profile("grmpy"):
        ran.append(1)
    assert ran == [1]
    assert [r.levelname for r in caplog.records] == ["WARNING"]


@pytest.fixture(scope="module")
def workload4(tmp_path_factory):
    from make_workload import generate

    wl = str(tmp_path_factory.mktemp("wl_prof"))
    generate(wl, n_events=4, depth=10, seed=2)
    return wl


def test_prof_host_on_the_cpu(workload4, capsys):
    from paragraph_tpu_torch.tools import prof_host

    assert prof_host.main(["--events", "4", "--workload", workload4,
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == {"extract_ms_per_event", "tables_ms_per_event",
                         "analysis_ms_per_event"}
    assert all(v > 0 for v in last.values())
    for stage in ("extraction", "build_pair_tables x3", "analysis"):
        assert f"===== {stage}:" in out


def test_prof_host_wants_a_workload(tmp_path):
    from paragraph_tpu_torch.tools import prof_host

    with pytest.raises(SystemExit, match="make_workload.py"):
        prof_host.main(["--workload", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("tool", ["kbench", "kbench2", "prof_host"])
def test_tools_run_by_path(tool):
    proc = subprocess.run(
        [sys.executable, f"paragraph_tpu_torch/tools/{tool}.py", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith(f"usage: {tool}")
