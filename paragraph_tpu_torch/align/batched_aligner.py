"""Batched graph aligner: device scoring + host traceback.

Counterpart of ``paragraph_tpu/align/batched_aligner.py``: all reads are
scored in four orientations (forward/reverse-complement x forward/reversed
graph), strand and uniqueness are selected vectorised, and only the
chosen orientation of each kept read goes through the exact native
traceback. Scores come either precomputed by a cross-event pass or from
two ``SingleGraphSW`` scorers, one on the graph (forward and
reverse-complement reads) and one on its reversal (their reversals);
there is no fallback engine, so a scoring failure raises.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from paragraph_tpu.align.graph_aligner import reverse_complement
from paragraph_tpu.align.gssw import GraphSW
from paragraph_tpu.align.native import NativeGraphSW, native_available
from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.reads.read import Read


def resolve_threads(threads: int) -> int:
    """threads<=0 means auto (hardware concurrency), mirroring the
    reference CLIs' std::thread::hardware_concurrency() default."""
    if threads and threads > 0:
        return threads
    return os.cpu_count() or 1


def make_orientation_batches(reads: List[Read]):
    """The four-orientation read batches of GraphAligner's protocol:
    forward graph scores fwd + revcomp reads; reversed graph scores their
    reversals. Returns (fwd_bases, rev_bases, fwd_batch, rev_batch)."""
    fwd_bases = [r.bases.upper() for r in reads]
    rev_bases = [reverse_complement(b) for b in fwd_bases]
    fwd_batch = fwd_bases + rev_bases
    rev_batch = [b[::-1] for b in fwd_bases] + [b[::-1] for b in rev_bases]
    return fwd_bases, rev_bases, fwd_batch, rev_batch


class BatchedGraphAligner:
    def __init__(self, graph: Optional[SequenceGraph] = None,
                 scoring: bool = True, threads: int = 1, device="cuda"):
        self._fwd_scorer = None
        self._rev_scorer = None
        self._fwd_scalar: Optional[GraphSW] = None
        self._fwd_native = None
        self._scoring = scoring
        self.threads = threads
        self.device = device
        #: which scoring engine ran ("cuda" | "torch" | "precomputed");
        #: surfaced in alignment_statistics
        self.engine = "none"
        if graph is not None:
            self.set_graph(graph)

    def set_graph(self, graph: SequenceGraph):
        if self._scoring:
            from ..ops.pallas_sw import SingleGraphSW

            self._fwd_scorer = SingleGraphSW(graph, device=self.device)
            self._rev_scorer = SingleGraphSW(graph.reversed(),
                                             device=self.device)
        self._fwd_scalar = GraphSW(graph)
        # C-speed traceback for kept reads when the native lib builds
        if native_available():
            self._fwd_native = NativeGraphSW(graph)

    def scorers(self):
        """The self-scoring scorers (none when built with scoring=False)."""
        return [sc for sc in (self._fwd_scorer, self._rev_scorer)
                if sc is not None]

    def _trace(self, chosen: str):
        """Exact fill+traceback of the chosen orientation: native C++ when
        available, Python oracle otherwise. Returns (score, pos, cigar)."""
        if self._fwd_native is not None:
            score, pos, _multi, cigar = self._fwd_native.align(chosen)
            return score, pos, cigar
        fills, max_node, _score = self._fwd_scalar.fill(chosen)
        gm = self._fwd_scalar.trace_back(fills, max_node, chosen)
        return gm.score, gm.position, gm.cigar_string()

    def align_reads_batch(self, reads: List[Read],
                          precomputed=None,
                          trace_uniq_only: bool = False) -> None:
        """Batch equivalent of calling GraphAligner::alignRead per read
        with AF_ALL flags.

        `precomputed` optionally carries (f_score, f_multi, r_multi[,
        f_end_node, f_end_ref, f_end_read]) from a cross-event scoring
        pass; the end-cell triple (when present) seeds the banded native
        traceback. `trace_uniq_only=True` skips the exact traceback for
        non-unique reads (valid only when the caller's filter chain drops
        them on the uniqueness flag alone and their CIGARs are never
        output).
        """
        if not reads:
            return
        fwd_bases, rev_bases, fwd_batch, rev_batch = \
            make_orientation_batches(reads)
        n = len(reads)

        f_ends = None  # (end_node, end_ref, end_read) vs the fwd graph
        if precomputed is not None:
            if len(precomputed) >= 6:
                (f_score, f_multi, r_multi,
                 f_en, f_er, f_erd) = precomputed[:6]
                f_ends = (f_en, f_er, f_erd)
            else:
                f_score, f_multi, r_multi = precomputed[:3]
            self.engine = "precomputed"
        else:
            if self._fwd_scorer is None:
                raise ValueError(
                    "aligner built with scoring=False got no scores")
            # both launches are queued before either output is fetched
            hf = self._fwd_scorer.score_device(fwd_batch)
            hr = self._rev_scorer.score_device(rev_batch)
            f_score, f_en, f_er, f_erd, f_multi = \
                self._fwd_scorer.finalize(hf)
            r_multi = self._rev_scorer.finalize(hr)[4]
            f_ends = (f_en, f_er, f_erd)
            self.engine = ("cuda" if self._fwd_scorer.device.type == "cuda"
                           else "torch")

        # vectorized strand choice (GraphAligner.cpp:340-356): unique
        # beats non-unique, then higher forward-graph score
        f_score = np.asarray(f_score)
        f_multi_b = np.asarray(f_multi, bool)
        r_multi_b = np.asarray(r_multi, bool)
        fwd_unique = ~f_multi_b[:n] & ~r_multi_b[:n]
        rev_unique = ~f_multi_b[n:2 * n] & ~r_multi_b[n:2 * n]
        return_reverse = np.where(
            fwd_unique != rev_unique, rev_unique,
            f_score[:n] < f_score[n:2 * n])
        unique_arr = np.where(return_reverse, rev_unique, fwd_unique)
        chosen_idx = np.where(return_reverse, np.arange(n) + n,
                              np.arange(n))
        chosen_scores = f_score[chosen_idx]

        chosen_list = []
        for i, read in enumerate(reads):
            if return_reverse[i]:
                chosen = rev_bases[i]
                read.bases = chosen
                read.quals = read.quals[::-1]
                read.is_graph_reverse_strand = not read.is_reverse_strand
            else:
                chosen = fwd_bases[i]
                read.is_graph_reverse_strand = read.is_reverse_strand
            chosen_list.append(chosen)

        # exact traceback on the chosen orientation only — banded around
        # the device-reported end cell when available (score-verified,
        # falls back to full width on any mismatch)
        if trace_uniq_only:
            trace_idx = np.nonzero(unique_arr)[0]
        else:
            trace_idx = np.arange(n)

        traces = [(int(chosen_scores[i]), 0, "", None) for i in range(n)]
        if len(trace_idx):
            if self._fwd_native is not None and f_ends is not None:
                # one native call for the whole batch; the per-read work
                # fans out over native threads (GIL released inside)
                en = np.asarray(f_ends[0])[chosen_idx[trace_idx]]
                er = np.asarray(f_ends[1])[chosen_idx[trace_idx]]
                erd = np.asarray(f_ends[2])[chosen_idx[trace_idx]]
                es = chosen_scores[trace_idx]
                sc, pos, cig, dec = self._fwd_native.align_at_batch(
                    [chosen_list[k] for k in trace_idx], en, er, erd, es,
                    n_threads=min(resolve_threads(self.threads), 16))
                for j, k in enumerate(trace_idx):
                    traces[k] = (sc[j], pos[j], cig[j], dec[j])
            else:
                for k in trace_idx:
                    if self._fwd_native is not None:
                        score, pos, _multi, cigar = self._fwd_native.align(
                            chosen_list[k])
                        traces[k] = (score, pos, cigar, None)
                    else:
                        traces[k] = self._trace(chosen_list[k]) + (None,)

        for i, read in enumerate(reads):
            score, pos, cigar, decoded = traces[i]
            read.graph_pos = pos
            read.graph_alignment_score = score
            read.is_graph_alignment_unique = bool(unique_arr[i])
            read.graph_mapq = 60 if unique_arr[i] else 0
            read.graph_cigar = cigar
            if decoded is not None:
                # seed the decode memo so filters/disambiguation/counting
                # never re-parse the CIGAR text (align/alignment.py:127)
                read._decoded_alignment = (pos, cigar, decoded)
