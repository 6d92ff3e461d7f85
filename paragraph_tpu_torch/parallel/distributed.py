"""Event-sharded scoring: the paired scorer over several devices.

Counterpart of ``paragraph_tpu/parallel/distributed.py`` (grmpy's thread
pool over (sample x graph), Workflow.cpp:224-231). (graph, reads) pairs
are packed into per-device *slots*, S slots make a *round*, and each
slot's paired fill (K1, ``ops/csrc/paired_sw.cu``) is launched on its
shard's device and stream. Every launch of every round is issued before
the first output is fetched, so shards on different cards run at the
same time. Events are independent: no shard talks to another.

The JAX code pads every shard to one shape and fills the last round with
shards that score no reads, because one SPMD program serves all shards.
Here each slot is launched at its own sizes and a short last round has
fewer launches; per-pair outputs do not depend on how pairs are cut into
launches (``PairedGraphSW``), so the outputs equal the one-device
scorer's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..graph.model import SequenceGraph
from ..ops.multi_sw import (COL_BUDGET, PAIR_BUDGET, PairedGraphSW,
                            pair_graph_arrays)
from .mesh import make_mesh


def make_event_mesh(device="cuda", n_devices: Optional[int] = None):
    """The event-sharding mesh: the process's local devices of `device`'s
    type (``make_mesh``). In a multi-process run each process shards the
    events it was given over its own cards (parallel/multihost.py), so
    scoring needs no cross-process traffic."""
    return make_mesh(device, n_devices)


class ShardedPairedSW(PairedGraphSW):
    """``PairedGraphSW``'s interface (``score_pairs_device``,
    ``finalize_pairs``, ``score_pairs``, ``stats``, ``engine_report``)
    with pairs sharded over a mesh. Its counters are the one-device
    scorer's: ``k1_s`` sums the device seconds of every slot's K1, each
    timed by CUDA events on its shard's stream, so over several cards it
    can exceed the wall time; ``engine_report``'s ``cells_per_k1_s`` is
    then the cells per card-second of K1.

    Pairs are packed into slots by the longest-processing-time greedy of
    the JAX code: at least min(S, n_pairs) slots, so that a small batch
    still spreads over the whole mesh, each bounded by ``col_budget``
    columns and ``PAIR_BUDGET`` pairs. Slot i belongs to round i // S and
    to shard i % S, and its graph tensors are placed once on that shard's
    device. One launch per slot: ``rounds`` lists each round's slots.
    """

    def __init__(self, graphs: Sequence[SequenceGraph], mesh=None,
                 col_budget: int = COL_BUDGET):
        from .. import resolve_device

        self.mesh = [resolve_device(d) for d in (
            mesh if mesh is not None else make_event_mesh())]
        S = len(self.mesh)
        if not S:
            raise ValueError("empty mesh")
        self.n_shards = S
        self.device = self.mesh[0]
        pair_gas = pair_graph_arrays(graphs)

        pair_cols = [len(fa.ref_codes) + len(ra.ref_codes)
                     for fa, ra in pair_gas]
        n_slots = max(min(S, len(pair_gas)),
                      -(sum(pair_cols) // -col_budget))
        slots: List[List[int]] = [[] for _ in range(n_slots)]
        loads = [0] * n_slots
        for i in sorted(range(len(pair_gas)), key=lambda i: -pair_cols[i]):
            k = min(range(len(slots)), key=lambda k: loads[k])
            if slots[k] and (loads[k] + pair_cols[i] > col_budget
                             or len(slots[k]) >= PAIR_BUDGET):
                slots.append([])
                loads.append(0)
                k = len(slots) - 1
            slots[k].append(i)
            loads[k] += pair_cols[i]
        self.slot_pairs = [s for s in slots if s]
        self.rounds: List[List[int]] = [
            list(range(r, min(r + S, len(self.slot_pairs))))
            for r in range(0, len(self.slot_pairs), S)]
        self._place(pair_gas, self.slot_pairs,
                    [self.mesh[i % S] for i in range(len(self.slot_pairs))])
