"""The port's pipelined path sharded over a mesh against the JAX package.

``run_grmpy`` with two samples of tests/test_torch_distributed.py's
make_workload run (8 events at 10x) and threads=2 takes the pipelined
path; over ``[cpu] * 4`` each round is one ShardedPairedSW with a launch
per shard. Its genotypes must equal the port's one-device pipelined run
and the JAX package's run, whose batch path shards over its 8 devices,
apart from the engine marker. (A module of its own so that each test
module of the port stays near a minute on one worker.)
"""
import pytest
import torch

from test_torch_distributed import _jax, _port, _same, workload  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner's workers share the machine's cores, and torch's
    intra-op pools spin: two workers with all-core pools starve each other.
    One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pipelined_path_sharded_matches(workload):  # noqa: F811
    stats = {}
    sharded = _port(workload, 2, 2, [CPU] * 4, stats)
    # one round of 8 events x 2 samples: 16 pairs over 4 shards
    assert stats["dispatches"] == 4
    assert set(stats["stage_s"]) >= {"graph_build", "score_dispatch"}
    assert len(sharded) == 8
    single = {}
    assert _same(sharded, _port(workload, 2, 2, None, single))
    assert single["dispatches"] == 1
    assert _same(sharded, _jax(workload, 2))
