"""ctypes binding for the native C++ graph-SW engine (native/graph_sw.cpp).

Builds the shared library on first use (make -C native), under a
cross-process lock; falls back gracefully when no compiler is available.
The native engine provides C-speed fill+traceback for CIGAR production
of kept reads while the TPU batched scorer handles orientation ranking.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

from ..graph.model import SequenceGraph

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libparagraph_sw.so")
#: the cross-process build lock, in _NATIVE_DIR
_LOCK_NAME = "libparagraph_sw.lock"

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _build_and_open() -> ctypes.CDLL:
    """Build the library if it is missing or older than its sources, and
    open it, under an exclusive lock on a file beside it shared by every
    process: one process builds while the others wait, then find it built
    and open it. Without the lock, processes racing on a fresh checkout
    open a library that another one is still writing."""
    with open(os.path.join(_NATIVE_DIR, _LOCK_NAME), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        srcs_mtime = max(
            os.path.getmtime(os.path.join(_NATIVE_DIR, f))
            for f in ("graph_sw.cpp", "bam_scan.cpp"))
        if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < srcs_mtime):
            subprocess.run(["make", "-C", _NATIVE_DIR],
                           check=True, capture_output=True)
        return ctypes.CDLL(_LIB_PATH)


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        try:
            lib = _build_and_open()
            lib.gsw_create.restype = ctypes.c_void_p
            lib.gsw_create.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.gsw_destroy.argtypes = [ctypes.c_void_p]
            lib.gsw_align.restype = ctypes.c_int
            lib.gsw_align.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.gsw_score.restype = ctypes.c_int
            lib.gsw_score.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.gsw_align_at.restype = ctypes.c_int
            lib.gsw_align_at.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, ctypes.c_int]
            lib.gsw_align_at_batch.restype = ctypes.c_int
            lib.gsw_align_at_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.bam_scan.restype = ctypes.c_int
            lib.bam_scan.argtypes = [
                ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
            lib.bam_decode_batch.restype = ctypes.c_int64
            lib.bam_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
            return _lib
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
            return None


def native_available() -> bool:
    return _load_lib() is not None


def load_native_lib():
    """The process-wide handle of the native runtime library (graph-SW
    fill/traceback + BAM record scanning), or None when it cannot be
    built. Shared by io/bam.py for its native fetch path."""
    return _load_lib()


class NativeGraphSW:
    """C-speed fill + traceback over one SequenceGraph orientation."""

    def __init__(self, graph: SequenceGraph):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native graph SW library unavailable")
        self._lib = lib
        self.graph = graph
        n = graph.num_nodes
        seqs = (ctypes.c_char_p * n)(
            *[graph.node_seq(i).encode() for i in range(n)])
        offsets = [0]
        preds = []
        for i in range(n):
            preds.extend(graph.predecessors(i))
            offsets.append(len(preds))
        off_arr = (ctypes.c_int * (n + 1))(*offsets)
        pred_arr = (ctypes.c_int * max(1, len(preds)))(*(preds or [0]))
        self._ctx = lib.gsw_create(n, seqs, off_arr, pred_arr)
        self._buf = ctypes.create_string_buffer(1 << 16)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ctx = getattr(self, "_ctx", None)
        if lib is not None and ctx:
            lib.gsw_destroy(ctx)
            self._ctx = None

    def align(self, read: str):
        """Returns (score, position, multi, cigar_string)."""
        score = ctypes.c_int()
        position = ctypes.c_int()
        multi = ctypes.c_int()
        rb = read.encode()
        ret = self._lib.gsw_align(
            self._ctx, rb, len(rb), ctypes.byref(score),
            ctypes.byref(position), ctypes.byref(multi), self._buf,
            len(self._buf))
        if ret != 0:
            raise RuntimeError("native alignment failed (cigar overflow?)")
        return (score.value, position.value, bool(multi.value),
                self._buf.value.decode())

    def score(self, read: str):
        score = ctypes.c_int()
        multi = ctypes.c_int()
        rb = read.encode()
        self._lib.gsw_score(self._ctx, rb, len(rb), ctypes.byref(score),
                            ctypes.byref(multi))
        return score.value, bool(multi.value)

    def align_at_batch(self, reads, end_nodes, end_refs, end_reads,
                       expected_scores, n_threads: int = 1,
                       cigar_stride: int = 2048, ops_stride: int = 128):
        """Banded fill + traceback for a whole read batch in ONE native
        call (per-read work fans out over n_threads inside the library,
        GIL released). Returns (scores, positions, cigars, decoded)
        lists; `decoded` carries a pre-built GraphAlignment per read
        (None where unavailable) so downstream analysis never re-parses
        the CIGAR text. Any read the band missed (score mismatch /
        stuck walk) transparently falls back to the exact full-width
        align()."""
        import numpy as np

        n = len(reads)
        if n == 0:
            return [], [], [], []
        concat = "".join(reads).encode()
        lens = np.fromiter((len(r) for r in reads), np.int64, count=n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        en = np.ascontiguousarray(end_nodes, np.int32)
        er = np.ascontiguousarray(end_refs, np.int32)
        erd = np.ascontiguousarray(end_reads, np.int32)
        es = np.ascontiguousarray(expected_scores, np.int32)
        rcs = np.zeros(n, np.int32)
        scores = np.zeros(n, np.int32)
        positions = np.zeros(n, np.int32)
        ops = np.zeros((n, ops_stride), np.int32)
        buf = ctypes.create_string_buffer(n * cigar_stride)
        ip = ctypes.POINTER(ctypes.c_int)
        self._lib.gsw_align_at_batch(
            self._ctx, concat,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            en.ctypes.data_as(ip), er.ctypes.data_as(ip),
            erd.ctypes.data_as(ip), es.ctypes.data_as(ip),
            int(n_threads), rcs.ctypes.data_as(ip),
            scores.ctypes.data_as(ip), positions.ctypes.data_as(ip),
            buf, cigar_stride,
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ops_stride)
        out_scores = scores.tolist()
        out_pos = positions.tolist()
        cigars = [""] * n
        decoded = [None] * n
        raw = buf.raw
        for i in range(n):
            if rcs[i] == 0:
                s = i * cigar_stride
                cigars[i] = raw[s:raw.index(b"\0", s)].decode()
                decoded[i] = _decode_ops_row(ops[i])
            else:
                sc, p, _multi, cig = self.align(reads[i])
                out_scores[i], out_pos[i], cigars[i] = sc, p, cig
        return out_scores, out_pos, cigars, decoded

    def align_at(self, read: str, end_node: int, end_ref: int,
                 end_read: int, expected_score: int):
        """Banded fill + traceback from a device-reported end cell
        (2*len+64-column band), verified against the device score;
        any mismatch falls back to the exact full-width align().
        Returns (score, position, cigar_string)."""
        score = ctypes.c_int()
        position = ctypes.c_int()
        rb = read.encode()
        ret = self._lib.gsw_align_at(
            self._ctx, rb, len(rb), int(end_node), int(end_ref),
            int(end_read), int(expected_score), ctypes.byref(score),
            ctypes.byref(position), self._buf, len(self._buf))
        if ret != 0:
            s, p, _multi, cig = self.align(read)
            return s, p, cig
        return score.value, position.value, self._buf.value.decode()


_OP_CHARS = "MXNSID"


def _decode_ops_row(row) -> "object":
    """Build a GraphAlignment from one integer ops row emitted by
    gsw_align_at_batch (layout documented at the C entry point). Returns
    None when the row is empty (overflow sentinel)."""
    n_nodes = int(row[0])
    if n_nodes <= 0:
        return None
    from .alignment import GraphAlignment, NodeAlignment

    position = int(row[1])
    node_ids = []
    alignments = []
    w = 2
    for k in range(n_nodes):
        node_ids.append(int(row[w]))
        n_ops = int(row[w + 1])
        w += 2
        ops = []
        for _ in range(n_ops):
            v = int(row[w])
            w += 1
            ops.append((v >> 3, _OP_CHARS[v & 7]))
        alignments.append(NodeAlignment(position if k == 0 else 0, ops))
    last = alignments[-1]
    path_end = last.reference_start + last.reference_length - 1
    return GraphAlignment(node_ids, alignments, position, path_end)
