"""Host table builders for the graph-SW fill, in numpy.

Counterpart of ``paragraph_tpu/ops/batched_sw.py`` (``GraphArrays``,
``encode_reads``, ``encode_blob``) and of ``pack_bits`` from
``paragraph_tpu/ops/pallas_sw.py``. They are copied rather than imported
because their JAX modules import jax; the arrays they build are
bit-identical (tests/test_torch_tables.py). The DP lives in
``ops/multi_sw.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..graph.model import SequenceGraph

_NT = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _NT[ord(_c)] = _i


@dataclass(frozen=True)
class GraphArrays:
    """Array representation of one sequence graph: concatenated node
    sequences with per-column node ids and a dense predecessor table."""

    ref_codes: np.ndarray  # int32[L] base classes of concatenated nodes
    col_node: np.ndarray  # int32[L] node id per column
    col_in_node: np.ndarray  # int32[L] column offset within node
    is_start: np.ndarray  # bool[L]
    is_last: np.ndarray  # bool[L]
    pred_table: np.ndarray  # int32[N, P]; value N = "zero state" slot
    num_nodes: int

    @classmethod
    def build(cls, graph: SequenceGraph, bucket: bool = True
              ) -> "GraphArrays":
        """With bucket=True, pad columns/nodes/preds to standard sizes.

        Padding appends disconnected fake nodes whose columns score 0
        against everything; they cannot affect scores, end cells, or (for
        nonzero alignments) the uniqueness count.
        """
        n_real = graph.num_nodes
        seqs = [graph.node_seq(nid).upper() for nid in range(n_real)]
        lens = np.fromiter((len(s) for s in seqs), np.int64, count=n_real)
        if n_real and int(lens.min()) == 0:
            raise ValueError(
                f"empty node sequence for node {int(lens.argmin())}")
        preds = [graph.predecessors(i) for i in range(n_real)]
        max_pred = max((len(p) for p in preds), default=1) or 1
        l_real = int(lens.sum())

        if bucket:
            n_bucket = -((n_real + 1) // -4) * 4
            n_fake = n_bucket - n_real
            p_bucket = -(max_pred // -2) * 2
            l_bucket = -((l_real + n_fake) // -64) * 64
        else:
            n_bucket = n_real
            n_fake = 0
            p_bucket = max_pred
            l_bucket = l_real

        pred_table = np.full((n_bucket, p_bucket), n_bucket, dtype=np.int32)
        for nid, plist in enumerate(preds):
            pred_table[nid, :len(plist)] = plist

        # fake filler nodes: first n_fake-1 are single columns, the last
        # absorbs the remaining padding
        if n_fake:
            pad_cols = l_bucket - l_real
            fake_lens = [1] * (n_fake - 1) + [pad_cols - (n_fake - 1)]
            all_lens = np.concatenate([lens, fake_lens]).astype(np.int64)
        else:
            all_lens = lens

        L = int(all_lens.sum())
        col_node = np.repeat(
            np.arange(len(all_lens), dtype=np.int32), all_lens)
        starts = np.zeros(len(all_lens), np.int64)
        np.cumsum(all_lens[:-1], out=starts[1:])
        col_in_node = (np.arange(L, dtype=np.int64)
                       - starts[col_node]).astype(np.int32)
        is_start = col_in_node == 0
        is_last = np.zeros(L, bool)
        is_last[np.cumsum(all_lens) - 1] = True
        ref_codes = np.full(L, 4, np.int32)  # fake cols: 'N' class
        if l_real:
            data = np.frombuffer("".join(seqs).encode(), np.uint8)
            ref_codes[:l_real] = _NT[data]

        return cls(
            ref_codes=ref_codes,
            col_node=col_node,
            col_in_node=col_in_node,
            is_start=is_start,
            is_last=is_last,
            pred_table=pred_table,
            num_nodes=n_bucket,
        )


def _encode(data: np.ndarray, lens: np.ndarray, pad_to: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Code matrix (pad class 5) + real and striped-pad lengths.

    Striped padding (gssw_qP_byte, gssw.c:78-97) rounds each read up to
    16-lane stripes; lanes in [len, 16*ceil(len/16)) behave as score-0
    positions and must be modelled for end/uniqueness parity.
    """
    n = len(lens)
    max_len = int(lens.max()) if n else 1
    m = max(pad_to, ((max_len + 15) // 16) * 16)
    codes = np.full((n, m), 5, dtype=np.int32)
    if n:
        if (lens == lens[0]).all():  # uniform-length fast path
            codes[:, :lens[0]] = _NT[data].reshape(n, lens[0])
        else:
            rows = np.repeat(np.arange(n, dtype=np.int64), lens)
            starts = np.concatenate(
                ([0], np.cumsum(lens[:-1], dtype=np.int64)))
            offs = np.arange(len(data), dtype=np.int64) - starts[rows]
            codes[rows, offs] = _NT[data]
    vlens = ((lens + 15) // 16) * 16
    return codes, lens, vlens.astype(np.int32)


def encode_reads(reads: List[str], pad_to: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode read strings to (codes [n, m], lens, vlens)."""
    lens = np.fromiter((len(r) for r in reads), np.int32, count=len(reads))
    data = np.frombuffer("".join(reads).upper().encode(), np.uint8)
    return _encode(data, lens, pad_to)


def encode_blob(blob: bytes, lens: np.ndarray, pad_to: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """encode_reads for pre-concatenated UPPER-CASE read bases (the
    (blob, lens) form the pipelined orchestrator's workers ship)."""
    lens = np.asarray(lens, np.int32)
    return _encode(np.frombuffer(blob, np.uint8), lens, pad_to)


def _bit_length(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def pack_bits(L: int, M: int, match: int):
    """Bit split for the packed end-cell tracking word:
    [ score | inverted column (col_bits) | inverted read row (j_bits) ].
    Returns (col_bits, j_bits), or None when scores could overflow the
    score bits."""
    col_bits = _bit_length(L)
    j_bits = _bit_length(M)
    score_bits = 31 - col_bits - j_bits
    if score_bits < 1 or match * M >= (1 << score_bits):
        return None
    return col_bits, j_bits
