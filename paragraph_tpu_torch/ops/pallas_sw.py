"""Single-graph graph-SW scoring: one graph, all its reads, one launch.

Counterpart of ``paragraph_tpu/ops/pallas_sw.py``. The host tables are
the port's ``GraphArrays`` / ``encode_reads`` (``ops/batched_sw.py``).
The fill has two engines over the same tensors:

- ``graph_fill``: the hand-written CUDA kernel ``ops/csrc/graph_sw.cu``
  for a CUDA tensor; the plain version for a CPU tensor;
- ``graph_fill_reference``: the plain PyTorch version, vectorised over
  lanes with one step per graph column. It is the CPU engine and the
  kernel's oracle.

Output per lane, [4, B] int32: score, global end column (-1 when the
score is 0), end read row and the multi-node flag (alignsEndAtMultNodes).
Neither engine packs the end cell into one word, so unlike the JAX
scorer there is no score range that needs a second engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..graph.model import SequenceGraph
from ..utils.profiling import (dispatch_serials, kernel_seconds, span,
                               timing_events)

from . import _build
from .batched_sw import GraphArrays, encode_reads
from .multi_sw import (LANES_PER_BLOCK, TILE_LANES, WARP_LANES_PER_CTA,
                       _bucket, _to_device, check_tensors, scorer_stats,
                       warp_grid)

_BIG = 2 ** 30


@dataclass(frozen=True)
class GraphFillTables:
    """The tensors of one single-graph fill, on one device, named as the
    arguments of the JAX package's ``pallas_fill``.

    ref_codes / col_node / is_start / is_last i32[L]; pred_table i32[N, P]
    (value N = zero state); read_codes_t i8[M, B]; lens / vlens i32[1, B].
    """

    ref_codes: "torch.Tensor"
    col_node: "torch.Tensor"
    is_start: "torch.Tensor"
    is_last: "torch.Tensor"
    pred_table: "torch.Tensor"
    read_codes_t: "torch.Tensor"
    lens: "torch.Tensor"
    vlens: "torch.Tensor"

    @property
    def device(self):
        return self.ref_codes.device


def _graph_tensors(a: GraphArrays, device):
    """(ref_codes, col_node, is_start, is_last, pred_table) on the device."""
    return tuple(_to_device(x, device) for x in (
        a.ref_codes.astype(np.int32), a.col_node.astype(np.int32),
        a.is_start.astype(np.int32), a.is_last.astype(np.int32),
        a.pred_table.astype(np.int32)))


def graph_tables_from_numpy(arrays: GraphArrays, codes_t: np.ndarray,
                            lens: np.ndarray, vlens: np.ndarray, device
                            ) -> GraphFillTables:
    """GraphFillTables from numpy outputs of either package's builders:
    a ``GraphArrays`` and the [M, B] codes with [1, B] lens / vlens."""
    from .. import resolve_device

    device = resolve_device(device)
    return GraphFillTables(
        *_graph_tensors(arrays, device),
        read_codes_t=_to_device(codes_t.astype(np.int8), device),
        lens=_to_device(np.asarray(lens, np.int32).reshape(1, -1), device),
        vlens=_to_device(np.asarray(vlens, np.int32).reshape(1, -1), device))


def graph_fill_reference(t: GraphFillTables, gap_open: int = 6,
                         gap_extend: int = 1, match: int = 1,
                         mismatch: int = 4):
    """The single-graph fill in plain PyTorch ops: [4, B] int32 on t's
    device.

    State is [M, B] (read row x lane), one step per graph column. Saved
    boundary states are [N+1, M, B]; slot N stays zero. F is the
    exclusive prefix max along rows of hp - gapO + (j+1) gapE, minus
    j gapE and clamped at 0 (exact because gap_open >= gap_extend); E is
    clamped at 0, as in the TPU kernel. The end cell is tracked unpacked:
    a column's maximum over stripe rows and the first row that attains
    it replace the running best where the maximum is strictly greater,
    which is gssw's tie-break. A zero score gives end column -1 and end
    row 0.
    """
    import torch

    dev = t.device
    i32 = torch.int32
    N, P = t.pred_table.shape
    M, B = t.read_codes_t.shape
    L = t.ref_codes.shape[0]
    # host copies of the per-column stream: the loop below branches on them
    ref_codes = t.ref_codes.tolist()
    col_node = t.col_node.tolist()
    is_start = t.is_start.tolist()
    is_last = t.is_last.tolist()
    preds = t.pred_table.tolist()

    x = t.read_codes_t.to(i32)
    lens = t.lens[0]
    vlens = t.vlens[0]
    prof_all = torch.stack(
        [torch.where(x == c, match, torch.where(x < 4, -mismatch, 0))
         for c in range(4)] + [torch.zeros_like(x)]).to(i32)  # [5, M, B]
    jj = torch.arange(M, dtype=i32, device=dev)[:, None]  # [M, 1]
    stripe = jj < vlens
    real = jj < lens
    gterm = (jj + 1) * gap_extend - gap_open
    row_big = torch.where(stripe, jj, _BIG)

    zero_row = torch.zeros((1, B), dtype=i32, device=dev)
    neg_row = torch.full((1, B), -_BIG, dtype=i32, device=dev)
    h = torch.zeros((M, B), dtype=i32, device=dev)
    e = torch.zeros((M, B), dtype=i32, device=dev)
    saved_h = torch.zeros((N + 1, M, B), dtype=i32, device=dev)
    saved_e = torch.zeros((N + 1, M, B), dtype=i32, device=dev)
    node_max = torch.zeros((N, B), dtype=i32, device=dev)
    nodecol = torch.zeros(B, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_col = torch.zeros(B, dtype=i32, device=dev)
    best_row = torch.zeros(B, dtype=i32, device=dev)

    for c in range(L):
        nid = col_node[c]
        if is_start[c]:
            ps = preds[nid]
            h = saved_h[ps].amax(0)
            e = saved_e[ps].amax(0)
            nodecol = torch.zeros_like(nodecol)
        diag = torch.cat([zero_row, h[:-1]], 0)
        hp = torch.maximum(torch.clamp_min(diag + prof_all[ref_codes[c]], 0),
                           e)
        g = torch.cummax(hp + gterm, 0).values
        f = torch.clamp_min(torch.cat([neg_row, g[:-1]], 0)
                            - jj * gap_extend, 0)
        h = torch.maximum(hp, f)
        e = torch.clamp_min(torch.maximum(e - gap_extend, h - gap_open), 0)

        h_stripe = torch.where(stripe, h, 0)
        col_max = h_stripe.amax(0)
        first = torch.where(h_stripe == col_max, row_big, _BIG).amin(0)
        upd = col_max > best
        best = torch.where(upd, col_max, best)
        best_col = torch.where(upd, c, best_col)
        best_row = torch.where(upd, first, best_row)
        nodecol = torch.maximum(nodecol, torch.where(real, h, 0).amax(0))
        if is_last[c]:
            saved_h[nid] = h
            saved_e[nid] = e
            node_max[nid] = nodecol

    n_top = (node_max == best).sum(0)
    zero = best == 0
    return torch.stack([
        best,
        torch.where(zero, -1, best_col),
        torch.where(zero, 0, torch.minimum(best_row, lens - 1)),
        (n_top > 1).to(i32),
    ]).to(i32)


_WANT = {
    "ref_codes": (1, "int32"), "col_node": (1, "int32"),
    "is_start": (1, "int32"), "is_last": (1, "int32"),
    "pred_table": (2, "int32"), "read_codes_t": (2, "int8"),
    "lens": (2, "int32"), "vlens": (2, "int32"),
}


def _check_tables(t: GraphFillTables) -> None:
    check_tensors(t, _WANT)
    L = t.ref_codes.shape[0]
    M, B = t.read_codes_t.shape
    for name in ("col_node", "is_start", "is_last"):
        if getattr(t, name).shape[0] != L:
            raise ValueError(f"{name} must have the {L} columns of ref_codes")
    if L == 0 or B == 0 or M == 0 or min(t.pred_table.shape) == 0:
        raise ValueError("empty graph, read or lane axis")
    if t.lens.shape != (1, B) or t.vlens.shape != (1, B):
        raise ValueError("lens / vlens must be [1, B]")


def graph_fill(t: GraphFillTables, gap_open: int = 6, gap_extend: int = 1,
               match: int = 1, mismatch: int = 4, events=None):
    """The single-graph fill: [4, B] int32 on t's device.

    On CUDA tensors this launches the kernel of ops/csrc/graph_sw.cu on
    the current stream (built at first use, see ops/_build.py) and raises
    on anything it cannot take; on CPU tensors it runs
    graph_fill_reference. ``graph_fill.launches`` counts kernel launches.
    `events`, a (start, end) pair of CUDA events, is recorded around the
    launch (``_build.launch``).
    """
    dev = t.device
    if dev.type == "cpu":
        return graph_fill_reference(t, gap_open, gap_extend, match, mismatch)
    if dev.type != "cuda":
        raise ValueError(f"graph_fill runs on cuda or cpu, not {dev}")
    _check_tables(t)
    N, P = t.pred_table.shape
    M, B = t.read_codes_t.shape
    L = t.ref_codes.shape[0]
    # past 832 read rows the kernel runs in row bands over all L columns:
    # any M is taken
    grid, words = warp_grid(N, M, B, gap_open, gap_extend, band_cols=L)
    out = _build.launch(
        "graph_sw_launch", dev, words, B,
        [t.ref_codes, t.col_node, t.is_start, t.is_last, t.pred_table,
         t.read_codes_t, t.lens, t.vlens],
        [L, N, P, M, B, WARP_LANES_PER_CTA, grid, gap_open, gap_extend,
         match, mismatch], events)
    graph_fill.launches += 1
    return out


graph_fill.launches = 0


class SingleGraphSW:
    """Scorer of a batch of reads against one graph (the counterpart of
    the JAX package's ``PallasGraphSW``). The graph's tables go to the
    device once, at construction.

    A dispatch's lanes are padded with 1-base reads to a multiple of
    ``tile_batch`` (a multiple of 32 lanes); the JAX
    scorer's further power-of-two bucket, which only served compile
    reuse, is gone.
    """

    def __init__(self, graph: SequenceGraph, match: int = 1,
                 mismatch: int = 4, gap_open: int = 6, gap_extend: int = 1,
                 tile_batch: int = TILE_LANES, device="cuda"):
        from .. import resolve_device

        if tile_batch <= 0 or tile_batch % LANES_PER_BLOCK:
            raise ValueError(f"tile_batch {tile_batch} is not a multiple "
                             f"of {LANES_PER_BLOCK}")
        self.device = resolve_device(device)
        self.graph = graph
        self.arrays = GraphArrays.build(graph)
        self.match = match
        self.mismatch = mismatch
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.tile_batch = tile_batch
        self._graph_dev = _graph_tensors(self.arrays, self.device)
        #: per-run observability, with PairedGraphSW.stats' keys (k1_s
        #: holds this kernel's, K3's, device seconds)
        self.stats = scorer_stats()

    def score_device(self, reads: List[str], pad_to: int = 0):
        """Launch the fill and return a handle without synchronising;
        finalize() fetches it."""
        serial = next(dispatch_serials)
        with span("scorer.tables", self.stats, "tables_s", serial):
            n_real = len(reads)
            b = _bucket(max(1, n_real), self.tile_batch)
            reads = list(reads) + ["A"] * (b - n_real)
            max_len = max(len(r) for r in reads)
            pad_to = max(pad_to, _bucket(max_len, 32))
            codes, lens, vlens = encode_reads(reads, pad_to)
        with span("scorer.put", self.stats, "put_s", serial):
            tables = GraphFillTables(
                *self._graph_dev,
                read_codes_t=_to_device(codes.T.astype(np.int8),
                                        self.device),
                lens=_to_device(lens[None, :], self.device),
                vlens=_to_device(vlens[None, :], self.device))
        events = timing_events(self.device)
        with span("scorer.launch", self.stats, "call_s", serial):
            out = graph_fill(tables, self.gap_open, self.gap_extend,
                             self.match, self.mismatch, events)
        self.stats["dispatches"] += 1
        self.stats["cells"] += len(self.arrays.ref_codes) * b \
            * codes.shape[1]
        return out, n_real, serial, events

    def finalize(self, handle):
        """One device-to-host copy of the [4, B] output; the winning
        column maps to (node id, in-node offset) with two host gathers."""
        out, n_real, serial, events = handle
        with span("scorer.fetch", self.stats, "device_wait_s", serial):
            vals = out.cpu().numpy()
        self.stats["k1_s"] += kernel_seconds(self.device, events)
        with span("scorer.slice", self.stats, "slice_s", serial):
            a = self.arrays
            score, end_col, end_read, multi = vals[:, :n_real]
            valid = end_col >= 0
            safe_col = np.where(valid, end_col, 0)
            end_node = np.where(valid, a.col_node[safe_col],
                                0).astype(np.int32)
            end_ref = np.where(
                valid, a.col_in_node[safe_col], -1).astype(np.int32)
        return score, end_node, end_ref, end_read, multi

    def score(self, reads: List[str], pad_to: int = 0):
        """(score, end_node, end_ref, end_read, multi) numpy arrays over
        the reads, as ``PallasGraphSW.score`` returns them."""
        return self.finalize(self.score_device(reads, pad_to))
