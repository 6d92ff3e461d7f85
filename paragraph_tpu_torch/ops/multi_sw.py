"""Multi-event paired graph-SW scoring: many graphs, one kernel launch.

Counterpart of ``paragraph_tpu/ops/multi_sw.py``. The host half (column
streams, predecessor tables, per-dispatch read tables, output slicing) is
numpy and bit-identical to the JAX builders. The fill has two engines
over the same tensors:

- ``paired_fill``: the hand-written CUDA kernel ``ops/csrc/paired_sw.cu``
  for a CUDA tensor; the plain version for a CPU tensor;
- ``paired_fill_reference``: the plain PyTorch version, vectorised over
  lanes and looping over event-local column steps. It is the CPU engine
  and the kernel's oracle.

``multi_fill`` / ``multi_fill_reference`` are the same fill on read codes
already expanded on the host (the JAX package's ``multi_pallas_fill``),
behind ``MultiGraphSW``.

Each lane is one read orientation scored against one event's column
range; a tile of TB lanes shares the event. Output per lane, [4, B]
int32: score, global end column (-1 when the score is 0), end read row
and the multi-node flag (alignsEndAtMultNodes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..graph.model import SequenceGraph

from . import _build
from .batched_sw import GraphArrays, encode_blob, encode_reads, pack_bits

_BIG = 2 ** 30
#: lanes per tile: the read orientations of one event scored together
TILE_LANES = 128
#: plain caps on one dispatch's pairs and concatenated graph columns
PAIR_BUDGET = 48
COL_BUDGET = 49152
#: device memory the kernel's per-CTA scratch (saved boundary states and
#: node maxima) may take in one launch; the launch's grid is capped so
#: that the scratch stays within it, whatever the dispatch's size
SCRATCH_BUDGET = 1 << 30
#: lanes per tile are a multiple of it (no kernel takes it as a CTA width)
LANES_PER_BLOCK = 32
#: lanes (warps) per CTA of the warp-per-lane kernels (paired_sw.cu,
#: graph_sw.cu, kbench_sw.cu); it divides LANES_PER_BLOCK, so a CTA's
#: lanes share one tile
WARP_LANES_PER_CTA = 4


def _bucket(x: int, m: int) -> int:
    return -(x // -m) * m


class MultiGraphArrays:
    """Concatenated host arrays for a batch of graphs.

    ``n_max`` / ``p_max`` raise the node and predecessor axes to at least
    the given sizes (MultiGraphSW gives every chunk the batch's maxima);
    ``l_to`` and ``e_to`` pad the column stream and the event axis of the
    predecessor tables (all zero-state) to at least the given lengths.
    """

    def __init__(self, graphs: Sequence[SequenceGraph],
                 prebuilt: Sequence[GraphArrays] = None,
                 n_max: int = 0, p_max: int = 0,
                 l_to: int = 0, e_to: int = 0):
        arrays = list(prebuilt) if prebuilt is not None else \
            [GraphArrays.build(g) for g in graphs]
        self.per_event = arrays
        self.n_max = max(n_max, max(a.num_nodes for a in arrays))
        self.p_max = max(p_max, max(a.pred_table.shape[1] for a in arrays))
        self.col_len = [len(a.ref_codes) for a in arrays]
        ends = np.cumsum([0] + self.col_len)
        self.col_start = ends[:-1].tolist()
        l_real = int(ends[-1])
        l_bucket = max(_bucket(max(1, l_real), 1024), l_to)
        e_total = max(len(arrays), e_to)

        def cat(parts, dtype, pad_val):
            out = np.full(l_bucket, pad_val, dtype)
            out[:l_real] = np.concatenate(parts)
            return out

        self.ref_codes = cat([a.ref_codes for a in arrays], np.int32, 4)
        self.col_node = cat([a.col_node for a in arrays], np.int32, 0)
        self.col_in_node = cat(
            [a.col_in_node for a in arrays], np.int32, 0)
        self.is_start = cat(
            [a.is_start.astype(np.int32) for a in arrays], np.int32, 0)
        self.is_last = cat(
            [a.is_last.astype(np.int32) for a in arrays], np.int32, 0)
        # one int32 per column: [ last(16) | start(15) | node id(14:3) |
        # ref code(2:0) ]; col_in_node stays on the host
        if self.n_max >= (1 << 12):
            raise ValueError(
                f"{self.n_max} nodes per event exceed the 12-bit node id "
                "of the packed column word")
        self.packed_cols = (self.ref_codes
                            | (self.col_node << 3)
                            | (self.is_start << 15)
                            | (self.is_last << 16)).astype(np.int32)
        pred_tables = np.full((e_total, self.n_max, self.p_max),
                              self.n_max, np.int32)
        for e, a in enumerate(arrays):
            pt = a.pred_table
            block = pred_tables[e, :pt.shape[0], :pt.shape[1]]
            np.copyto(block, pt)
            # remap each event's zero-state slot to the shared N_max slot
            block[pt == a.num_nodes] = self.n_max
        self.pred_tables = pred_tables  # [E, N_max, P_max]


def pair_tiles(n: int, tb: int) -> int:
    """Tiles a pair with n reads contributes under the packed layout: two
    blocks (fwd graph, rev graph) of bucket(2n, tb) lanes each."""
    return 2 * (_bucket(2 * n, tb) // tb) if n else 0


def pair_norm(reads) -> Tuple[bytes, np.ndarray]:
    """One pair's read set as (upper-case blob, int32 lens): accepts a
    list of read strings or an already-encoded (blob, lens) tuple."""
    if isinstance(reads, tuple):
        blob, lens = reads
        return blob, np.asarray(lens, np.int32)
    lens = np.fromiter((len(r) for r in reads), np.int32, count=len(reads))
    return "".join(reads).upper().encode(), lens


def pair_count(reads) -> int:
    return len(reads[1]) if isinstance(reads, tuple) else len(reads)


def pair_max_len(reads) -> int:
    if isinstance(reads, tuple):
        lens = reads[1]
        return int(np.max(lens)) if len(lens) else 0
    return max((len(r) for r in reads), default=0)


def build_pair_tables(a: MultiGraphArrays, reads_per_pair, tb: int):
    """Host tables for one paired dispatch: read encode, orientation
    expansion tables (col_idx/flip/comp) and per-tile (event, column
    range) assignments.

    Lanes pack the two orientations that walk the same graph into shared
    tiles: [fwd | revcomp] vs the forward graph, [rev | comp] vs the
    reversed graph. Pairs with no reads contribute no tiles. The JAX
    builder pads the tile count to a power of two so that one compiled
    program serves many dispatches; the kernel here takes its sizes at
    run time, so the only pad tile is the one a dispatch without reads
    needs (clen=0: its column loop never runs).
    """
    base_blobs: List[bytes] = []
    base_lens: List[np.ndarray] = []
    n_bases = 0
    col_chunks: List[np.ndarray] = []
    flip_chunks: List[np.ndarray] = []
    comp_chunks: List[np.ndarray] = []
    tile_event: List[int] = []
    tile_col_start: List[int] = []
    tile_col_len: List[int] = []
    layout = []  # (block_offsets[4], n) per pair
    lane_count = 0
    max_len = 1
    for j, reads in enumerate(reads_per_pair):
        n = pair_count(reads)
        if n == 0:
            layout.append(([0, 0, 0, 0], 0))
            continue
        base_off = n_bases
        blob, lens_j = pair_norm(reads)
        base_blobs.append(blob)
        base_lens.append(lens_j)
        n_bases += n
        max_len = max(max_len, int(lens_j.max()))
        lanes = _bucket(2 * n, tb)
        idx = np.arange(base_off, base_off + n, dtype=np.int32)
        lane_cols = np.concatenate(
            [idx, idx, np.full(lanes - 2 * n, base_off, np.int32)])
        offsets = []
        # per-pair blocks: [fwd | revcomp] vs fwd graph, then
        # [rev | comp] vs rev graph; offsets = [o_f, o_rc, o_rev, o_cp]
        for ev_local, (f0, c0), (f1, c1) in (
                (2 * j, (0, 0), (1, 1)), (2 * j + 1, (1, 0), (0, 1))):
            offsets.append(lane_count)
            offsets.append(lane_count + n)
            col_chunks.append(lane_cols)
            fl = np.zeros(lanes, np.int8)
            cp = np.zeros(lanes, np.int8)
            fl[:n] = f0
            fl[n:2 * n] = f1
            cp[:n] = c0
            cp[n:2 * n] = c1
            flip_chunks.append(fl)
            comp_chunks.append(cp)
            tile_event.extend([ev_local] * (lanes // tb))
            tile_col_start.extend([a.col_start[ev_local]] * (lanes // tb))
            tile_col_len.extend([a.col_len[ev_local]] * (lanes // tb))
            lane_count += lanes
        layout.append((offsets, n))
    if not tile_event:
        tile_event.append(0)
        tile_col_start.append(0)
        tile_col_len.append(0)
        col_chunks.append(np.zeros(tb, np.int32))
        flip_chunks.append(np.zeros(tb, np.int8))
        comp_chunks.append(np.zeros(tb, np.int8))
        base_blobs.append(b"A")
        base_lens.append(np.ones(1, np.int32))

    codes, lens, vlens = encode_blob(
        b"".join(base_blobs), np.concatenate(base_lens), _bucket(max_len, 32))
    # lane->base index: int16 while base column counts allow it
    col_idx = np.concatenate(col_chunks)
    if codes.shape[0] <= 32767:
        col_idx = col_idx.astype(np.int16)
    l_ev = _bucket(max(a.col_len), 256)
    if pack_bits(l_ev, codes.shape[1], 1) is None:
        raise ValueError(
            f"scores overflow the packed end-cell word (event columns "
            f"{l_ev}, read rows {codes.shape[1]})")
    return {
        "tile_col_start": np.asarray(tile_col_start, np.int32),
        "tile_col_len": np.asarray(tile_col_len, np.int32),
        "tile_event": np.asarray(tile_event, np.int32),
        "codes_t": codes.T.astype(np.int8),
        "lens": lens[None, :].astype(np.int32),
        "vlens": vlens[None, :].astype(np.int32),
        "col_idx": col_idx,
        "flip": np.concatenate(flip_chunks)[None, :],
        "comp": np.concatenate(comp_chunks)[None, :],
        "l_ev": l_ev,
        "m": codes.shape[1],
        "layout": layout,
    }


def slice_pair_outputs(a: MultiGraphArrays, vals: np.ndarray, layout,
                       idxs, results) -> None:
    """Map one fetched [4, B] output block back to per-pair (f_out, r_out)
    5-tuples, resolving global columns to (node, in-node offset)."""
    score, end_col, end_read, multi = vals
    valid = end_col >= 0
    safe_col = np.where(valid, end_col, 0)
    end_node = np.where(valid, a.col_node[safe_col], 0).astype(np.int32)
    end_ref = np.where(valid, a.col_in_node[safe_col], -1).astype(np.int32)
    full = (score, end_node, end_ref, end_read, multi)
    for (offsets, n), p in zip(layout, idxs):
        o_f, o_rc, o_rev, o_cp = offsets
        f_out = tuple(
            np.concatenate([x[o_f:o_f + n], x[o_rc:o_rc + n]])
            for x in full)
        r_out = tuple(
            np.concatenate([x[o_rev:o_rev + n], x[o_cp:o_cp + n]])
            for x in full)
        results[p] = (f_out, r_out)


# --------------------------------------------------------------------------
# tensors of one dispatch


@dataclass(frozen=True)
class FillTables:
    """The tensors of one paired fill, on one device, named as the
    arguments of the JAX package's ``paired_pallas_fill``.

    packed_cols i32[L]; pred_tables i32[E, N, P] (slot N = zero state);
    tile_col_start / tile_col_len / tile_event i32[T]; base_codes_t
    i8[M, Bb]; base_lens / base_vlens i32[1, Bb]; col_idx i16 or i32[B];
    flip / comp i8[1, B], with B = T * TB. ``l_ev`` bounds one event's
    column count for the packed end-cell word.
    """

    packed_cols: "torch.Tensor"
    pred_tables: "torch.Tensor"
    tile_col_start: "torch.Tensor"
    tile_col_len: "torch.Tensor"
    tile_event: "torch.Tensor"
    base_codes_t: "torch.Tensor"
    base_lens: "torch.Tensor"
    base_vlens: "torch.Tensor"
    col_idx: "torch.Tensor"
    flip: "torch.Tensor"
    comp: "torch.Tensor"
    l_ev: int

    @property
    def device(self):
        return self.packed_cols.device


def _to_device(x: np.ndarray, device):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        # pinned source: the copy is queued on the stream and the host
        # does not wait for kernels already in flight
        return t.pin_memory().to(device, non_blocking=True)
    return t


def graph_tensors(a: MultiGraphArrays, device):
    """(packed_cols, pred_tables) of a chunk, on the device."""
    return _to_device(a.packed_cols, device), _to_device(a.pred_tables,
                                                         device)


def dispatch_tables(t: dict, packed_cols, pred_tables, device) -> FillTables:
    """FillTables from build_pair_tables' dict and a chunk's resident
    graph tensors."""
    return FillTables(
        packed_cols=packed_cols, pred_tables=pred_tables,
        tile_col_start=_to_device(t["tile_col_start"], device),
        tile_col_len=_to_device(t["tile_col_len"], device),
        tile_event=_to_device(t["tile_event"], device),
        base_codes_t=_to_device(t["codes_t"], device),
        base_lens=_to_device(t["lens"], device),
        base_vlens=_to_device(t["vlens"], device),
        col_idx=_to_device(t["col_idx"], device),
        flip=_to_device(t["flip"], device),
        comp=_to_device(t["comp"], device),
        l_ev=int(t["l_ev"]))


def tables_from_numpy(pair_tables: dict, multi_arrays, device
                      ) -> FillTables:
    """FillTables from numpy outputs of either package's builders
    (``build_pair_tables``' dict and a ``MultiGraphArrays``)."""
    from .. import resolve_device

    device = resolve_device(device)
    return dispatch_tables(pair_tables, *graph_tensors(multi_arrays, device),
                           device)


def _pack_split(l_ev: int, m: int, match: int):
    bits = pack_bits(l_ev, m, match)
    if bits is None:
        raise ValueError(
            f"scores overflow the packed end-cell word (event columns "
            f"{l_ev}, read rows {m}, match {match})")
    return bits


def _fill_reference(packed_cols, pred_tables, tile_col_start, tile_col_len,
                    tile_event, codes, lens, vlens, l_ev: int, gap_open: int,
                    gap_extend: int, match: int, mismatch: int,
                    scan: bool = True, track: bool = True,
                    branches: bool = True):
    """The multi-event fill over expanded read codes (int32 [M, B], with
    lens / vlens [B]): the body of paired_fill_reference and
    multi_fill_reference.

    The three switches are the functional knobs of the kernel benchmark's
    ablation variants (tools/kbench2.py), off only there: ``scan=False``
    drops the F recurrence (H = H'), ``track=False`` the end-cell tracking
    (every packed word stays 0), ``branches=False`` the node-start seeding
    and the node-end saves (H and E run on across node boundaries in
    column order, every node maximum stays 0)."""
    import torch

    dev = codes.device
    i32 = torch.int32
    n_ev, N, P = pred_tables.shape
    M, B = codes.shape
    T = tile_event.shape[0]
    TB = B // T
    col_bits, j_bits = _pack_split(l_ev, M, match)
    s1 = col_bits + j_bits
    lmask = (1 << col_bits) - 1
    jmask = (1 << j_bits) - 1

    # score of each row against reference class 0-3; class 4 (N, pad
    # column) scores 0, as do read codes 4 (N) and 5 (pad)
    prof_all = torch.stack(
        [torch.where(codes == c, match, torch.where(codes < 4, -mismatch, 0))
         for c in range(4)] + [torch.zeros_like(codes)]).to(i32)  # [5, M, B]

    jj = torch.arange(M, dtype=i32, device=dev)[:, None]  # [M, 1]
    lanes = torch.arange(B, device=dev)
    tile = lanes // TB
    ev = tile_event[tile].long()
    c0 = tile_col_start[tile]
    clen = tile_col_len[tile]
    stripe = jj < vlens  # [M, B]
    real = jj < lens
    jterm = torch.where(stripe, jmask - jj, -_BIG)
    gterm = jj * gap_extend + (gap_extend - gap_open)
    fterm = jj[1:] * gap_extend

    zero_row = torch.zeros((1, B), dtype=i32, device=dev)
    h = torch.zeros((M, B), dtype=i32, device=dev)
    e = torch.zeros((M, B), dtype=i32, device=dev)
    saved_h = torch.zeros((N + 1, M, B), dtype=i32, device=dev)
    saved_e = torch.zeros((N + 1, M, B), dtype=i32, device=dev)
    node_max = torch.zeros((N, B), dtype=i32, device=dev)
    nodecol = torch.zeros(B, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    L = packed_cols.shape[0]

    for step in range(int(clen.max())):
        active = step < clen
        pc = packed_cols[(c0 + step).clamp(max=L - 1).long()]
        ref_c = pc & 7
        nid = ((pc >> 3) & 0xFFF).long()
        starts = torch.nonzero(active & ((pc >> 15) & 1 != 0)).squeeze(1)
        if branches and starts.numel():
            preds = pred_tables[ev[starts], nid[starts]].long()  # [S, P]
            sh = saved_h[preds[:, 0], :, starts]
            se = saved_e[preds[:, 0], :, starts]
            for p in range(1, P):
                sh = torch.maximum(sh, saved_h[preds[:, p], :, starts])
                se = torch.maximum(se, saved_e[preds[:, p], :, starts])
            h[:, starts] = sh.T
            e[:, starts] = se.T
            nodecol[starts] = 0

        prof = prof_all.gather(0, ref_c.long().expand(1, M, B))[0]
        diag = torch.cat([zero_row, h[:-1]], 0)
        hp = torch.maximum(torch.clamp_min(diag + prof, 0), e)
        hn = hp
        if scan:
            g = hp + gterm
            shift = 1
            while shift < M:  # inclusive prefix max over rows
                g = torch.cat([g[:shift],
                               torch.maximum(g[shift:], g[:-shift])])
                shift *= 2
            f = torch.cat([zero_row, torch.clamp_min(g[:-1] - fterm, 0)], 0)
            hn = torch.maximum(hp, f)
        en = torch.maximum(e, hn - (gap_open - gap_extend)) - gap_extend
        h = torch.where(active, hn, h)
        e = torch.where(active, en, e)

        if track:
            packed = (hn << s1) + (((lmask - step) << j_bits) + jterm)
            best = torch.where(active, torch.maximum(best, packed.amax(0)),
                               best)
        col_real = torch.where(real, hn, 0).amax(0)
        nodecol = torch.where(active, torch.maximum(nodecol, col_real),
                              nodecol)

        lasts = torch.nonzero(active & ((pc >> 16) & 1 != 0)).squeeze(1)
        if branches and lasts.numel():
            nl = nid[lasts]
            saved_h[nl, :, lasts] = hn[:, lasts].T
            saved_e[nl, :, lasts] = en[:, lasts].T
            node_max[nl, lasts] = nodecol[lasts]

    score = best >> s1
    end_col = c0 + (lmask - ((best >> j_bits) & lmask))
    first_j = jmask - (best & jmask)
    n_top = (node_max == score).sum(0)
    zero = score == 0
    return torch.stack([
        score,
        torch.where(zero, -1, end_col),
        torch.where(zero, 0, torch.minimum(first_j, lens - 1)),
        (n_top > 1).to(i32),
    ]).to(i32)


def paired_fill_reference(t: FillTables, gap_open: int = 6,
                          gap_extend: int = 1, match: int = 1,
                          mismatch: int = 4):
    """The paired fill in plain PyTorch ops: [4, B] int32 on t's device.

    The lanes' codes are first expanded into orientation (gather by
    col_idx, per-lane row flip below the read length, complement of
    ACGT). State is then [M, B] (read row x lane). Step s walks column
    tile_col_start + s of every lane whose tile has s < tile_col_len, so
    a call costs max(tile_col_len) steps. Saved boundary states are
    [N+1, M, B], gathered and scattered per lane by node id; slot N stays
    zero. F is the closed-form prefix max (exact because gap_open >=
    gap_extend); E is not clamped at zero, as in the TPU kernel (the
    outputs are the same either way, since hp = max(diag + prof, 0, E)
    absorbs any negative E). End tracking keeps the TPU kernel's packed
    word (score | inverted event-local column | inverted read row), which
    gives gssw's tie-break: highest score, then the first column where it
    is strictly attained, then the lowest read row.
    """
    x, lens, vlens = expand_orientations(t)
    return _fill_reference(
        t.packed_cols, t.pred_tables, t.tile_col_start, t.tile_col_len,
        t.tile_event, x, lens, vlens, t.l_ev, gap_open, gap_extend, match,
        mismatch)


def expand_orientations(t: FillTables):
    """Each lane's read codes in its orientation, int32 [M, B], with its
    lens / vlens [B]: the gather by col_idx, the row flip below the read
    length and the complement of ACGT that the paired kernel does at
    load."""
    import torch

    i32 = torch.int32
    M = t.base_codes_t.shape[0]
    ci = t.col_idx.long()
    codes = t.base_codes_t.to(i32)[:, ci]  # [M, B]
    lens = t.base_lens[0, ci]  # [B]
    vlens = t.base_vlens[0, ci]
    jj = torch.arange(M, dtype=i32, device=t.device)[:, None]
    flip_idx = torch.where(jj < lens, lens - 1 - jj, jj)
    flipped = torch.gather(codes, 0, flip_idx.long())
    x = torch.where(t.flip[0] != 0, flipped, codes)
    x = torch.where((t.comp[0] != 0) & (x < 4), 3 - x, x)
    return x, lens, vlens


def check_tensors(t, want: dict) -> None:
    """Raise unless each named tensor of `t` has the wanted (ndim, dtype
    name) and every tensor of `t` is contiguous on t.device."""
    import torch

    dev = t.device
    for name, (ndim, dtype) in want.items():
        x = getattr(t, name)
        if x.dtype != getattr(torch, dtype) or x.dim() != ndim:
            raise ValueError(f"{name}: want {dtype} with {ndim} dims, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, x in vars(t).items():
        if isinstance(x, torch.Tensor) and (
                x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {dev}")


def _check_tiles(t, B: int) -> None:
    T = t.tile_event.shape[0]
    if T == 0 or B % T or t.tile_col_start.shape[0] != T \
            or t.tile_col_len.shape[0] != T:
        raise ValueError(f"{B} lanes do not split into {T} tiles")
    if (B // T) % LANES_PER_BLOCK:
        raise ValueError(f"{B // T} lanes per tile are not a multiple of "
                         f"{LANES_PER_BLOCK}")


_TILE_WANT = {
    "packed_cols": (1, "int32"), "pred_tables": (3, "int32"),
    "tile_col_start": (1, "int32"), "tile_col_len": (1, "int32"),
    "tile_event": (1, "int32"),
}


def _check_tables(t: FillTables) -> None:
    import torch

    check_tensors(t, {**_TILE_WANT, "base_codes_t": (2, "int8"),
                      "base_lens": (2, "int32"), "base_vlens": (2, "int32"),
                      "flip": (2, "int8"), "comp": (2, "int8")})
    if t.col_idx.dtype not in (torch.int16, torch.int32) \
            or t.col_idx.dim() != 1:
        raise ValueError("col_idx must be int16 or int32 [B]")
    B = t.col_idx.shape[0]
    Bb = t.base_codes_t.shape[1]
    _check_tiles(t, B)
    if t.base_lens.shape != (1, Bb) or t.base_vlens.shape != (1, Bb):
        raise ValueError("base_lens / base_vlens must be [1, Bb]")
    if t.flip.shape != (1, B) or t.comp.shape != (1, B):
        raise ValueError("flip / comp must be [1, B]")


def warp_grid(N: int, M: int, B: int, gap_open: int, gap_extend: int):
    """(grid, scratch words) of a warp-per-lane launch (paired_sw.cu,
    graph_sw.cu, kbench_sw.cu), after refusing what those kernels do not
    take. Per lane the scratch holds saved H and E of N nodes over the
    R * 32 rows of its warp (R rows per thread, the library's choice for
    M) and N node maxima; the grid is capped so the scratch stays within
    SCRATCH_BUDGET."""
    if gap_extend < 0 or gap_open < gap_extend:
        raise ValueError(f"the fill needs gap_open >= gap_extend >= 0, got "
                         f"{gap_open}, {gap_extend}")
    rows = _build.load().sw_warp_rows(M)
    if rows == 0:
        raise ValueError(f"{M} read rows exceed what the kernels take")
    cta_words = (2 * N * rows * 32 + N) * WARP_LANES_PER_CTA
    grid = max(1, min(-(B // -WARP_LANES_PER_CTA),
                      SCRATCH_BUDGET // (4 * cta_words)))
    return grid, grid * cta_words


def paired_fill(t: FillTables, gap_open: int = 6, gap_extend: int = 1,
                match: int = 1, mismatch: int = 4):
    """The paired fill: [4, B] int32 on t's device.

    On CUDA tensors this launches the kernel of ops/csrc/paired_sw.cu on
    the current stream (built at first use, see ops/_build.py) and raises
    on anything it cannot take; on CPU tensors it runs
    paired_fill_reference. ``paired_fill.launches`` counts kernel
    launches.
    """
    dev = t.device
    if dev.type == "cpu":
        return paired_fill_reference(t, gap_open, gap_extend, match,
                                     mismatch)
    if dev.type != "cuda":
        raise ValueError(f"paired_fill runs on cuda or cpu, not {dev}")
    _check_tables(t)
    n_ev, N, P = t.pred_tables.shape
    M, Bb = t.base_codes_t.shape
    B = t.col_idx.shape[0]
    TB = B // t.tile_event.shape[0]
    _pack_split(t.l_ev, M, match)  # refuses what the plain fill refuses
    grid, words = warp_grid(N, M, B, gap_open, gap_extend)
    out = _build.launch(
        "paired_sw_launch", dev, words, B,
        [t.packed_cols, t.pred_tables, t.tile_col_start, t.tile_col_len,
         t.tile_event, t.base_codes_t, t.base_lens, t.base_vlens,
         t.col_idx, t.col_idx.element_size(), t.flip, t.comp],
        [B, TB, N, P, M, Bb, WARP_LANES_PER_CTA, grid, gap_open,
         gap_extend, match, mismatch])
    paired_fill.launches += 1
    return out


paired_fill.launches = 0


@dataclass(frozen=True)
class MultiFillTables:
    """The tensors of one multi-event fill on expanded read codes, named
    as the arguments of the JAX package's ``multi_pallas_fill``.

    packed_cols i32[L]; pred_tables i32[E, N, P] (slot N = zero state);
    tile_col_start / tile_col_len / tile_event i32[T]; read_codes_t
    i8[M, B]; lens / vlens i32[1, B], with B = T * TB. ``l_ev`` bounds
    one event's column count for the packed end-cell word.
    """

    packed_cols: "torch.Tensor"
    pred_tables: "torch.Tensor"
    tile_col_start: "torch.Tensor"
    tile_col_len: "torch.Tensor"
    tile_event: "torch.Tensor"
    read_codes_t: "torch.Tensor"
    lens: "torch.Tensor"
    vlens: "torch.Tensor"
    l_ev: int

    @property
    def device(self):
        return self.packed_cols.device


def multi_fill_reference(t: MultiFillTables, gap_open: int = 6,
                         gap_extend: int = 1, match: int = 1,
                         mismatch: int = 4):
    """The multi-event fill on expanded codes in plain PyTorch ops:
    paired_fill_reference without the orientation expansion."""
    import torch

    return _fill_reference(
        t.packed_cols, t.pred_tables, t.tile_col_start, t.tile_col_len,
        t.tile_event, t.read_codes_t.to(torch.int32), t.lens[0], t.vlens[0],
        t.l_ev, gap_open, gap_extend, match, mismatch)


def check_multi_tables(t: MultiFillTables) -> None:
    """Raise unless `t` holds what the multi-event kernels take: the
    dtypes and ranks of MultiFillTables, contiguous on one device, lanes
    that split into tiles of whole CTAs, lens / vlens [1, B]."""
    check_tensors(t, {**_TILE_WANT, "read_codes_t": (2, "int8"),
                      "lens": (2, "int32"), "vlens": (2, "int32")})
    B = t.read_codes_t.shape[1]
    _check_tiles(t, B)
    if t.lens.shape != (1, B) or t.vlens.shape != (1, B):
        raise ValueError("lens / vlens must be [1, B]")


def multi_fill(t: MultiFillTables, gap_open: int = 6, gap_extend: int = 1,
               match: int = 1, mismatch: int = 4):
    """The multi-event fill on expanded codes: [4, B] int32 on t's device.

    On CUDA tensors this launches the paired kernel's body with the
    orientation expansion off (``multi_sw_launch`` in
    ops/csrc/paired_sw.cu) and raises on anything it cannot take; on CPU
    tensors it runs multi_fill_reference. ``multi_fill.launches`` counts
    kernel launches.
    """
    dev = t.device
    if dev.type == "cpu":
        return multi_fill_reference(t, gap_open, gap_extend, match,
                                    mismatch)
    if dev.type != "cuda":
        raise ValueError(f"multi_fill runs on cuda or cpu, not {dev}")
    check_multi_tables(t)
    n_ev, N, P = t.pred_tables.shape
    M, B = t.read_codes_t.shape
    TB = B // t.tile_event.shape[0]
    _pack_split(t.l_ev, M, match)  # refuses what the plain fill refuses
    grid, words = warp_grid(N, M, B, gap_open, gap_extend)
    out = _build.launch(
        "multi_sw_launch", dev, words, B,
        [t.packed_cols, t.pred_tables, t.tile_col_start, t.tile_col_len,
         t.tile_event, t.read_codes_t, t.lens, t.vlens],
        [B, TB, N, P, M, WARP_LANES_PER_CTA, grid, gap_open, gap_extend,
         match, mismatch])
    multi_fill.launches += 1
    return out


multi_fill.launches = 0


class PairedGraphSW:
    """Scorer for the full 4-orientation protocol over an event batch:
    one pair = (graph, its reads); the reversed graph and all read
    orientations are derived internally (the orientations inside the
    fill). Graph column streams and predecessor tables are placed on the
    device once per chunk and reused by every dispatch.

    score_pairs() returns, per pair, two 5-tuples: f_out for [fwd +
    revcomp] reads vs the forward graph and r_out for their reversals vs
    the reversed graph.

    Pairs are cut into chunks of at most ``PAIR_BUDGET`` pairs and
    ``col_budget`` columns; one chunk is one fill launch. The kernel's
    device scratch is bounded by ``SCRATCH_BUDGET`` whatever the chunk
    holds (paired_fill caps its grid), so sizes need no other limit.
    Outputs per pair do not depend on the chunking.
    """

    def __init__(self, graphs: Sequence[SequenceGraph], device="cuda",
                 col_budget: int = COL_BUDGET):
        from .. import resolve_device

        self.device = resolve_device(device)
        #: per-run observability, read by the orchestrator's [kernel] line
        self.stats = {"dispatches": 0, "cells": 0, "lanes": 0,
                      "device_wait_s": 0.0, "dispatch_host_s": 0.0,
                      "tables_s": 0.0, "put_s": 0.0, "call_s": 0.0}
        built = {}

        def build(g):
            key = id(g)
            if key not in built:
                built[key] = (GraphArrays.build(g),
                              GraphArrays.build(g.reversed()))
            return built[key]

        pair_gas = [build(g) for g in graphs]
        self.chunk_pairs: List[List[int]] = []
        cur: List[int] = []
        cur_cols = 0
        for i, (fa, ra) in enumerate(pair_gas):
            cols = len(fa.ref_codes) + len(ra.ref_codes)
            if cur and (cur_cols + cols > col_budget
                        or len(cur) >= PAIR_BUDGET):
                self.chunk_pairs.append(cur)
                cur, cur_cols = [], 0
            cur.append(i)
            cur_cols += cols
        if cur:
            self.chunk_pairs.append(cur)
        self.chunk_arrays: List[MultiGraphArrays] = []
        self._chunk_dev = []
        for idxs in self.chunk_pairs:
            prebuilt = []
            for i in idxs:
                prebuilt.extend(pair_gas[i])
            a = MultiGraphArrays(None, prebuilt=prebuilt)
            self.chunk_arrays.append(a)
            self._chunk_dev.append(graph_tensors(a, self.device))

    def _dispatch(self, chunk_i: int, reads_per_pair):
        t_host = time.perf_counter()
        a = self.chunk_arrays[chunk_i]
        t = build_pair_tables(a, reads_per_pair, TILE_LANES)
        t0 = time.perf_counter()
        self.stats["tables_s"] += t0 - t_host
        tables = dispatch_tables(t, *self._chunk_dev[chunk_i], self.device)
        t1 = time.perf_counter()
        self.stats["put_s"] += t1 - t0
        out = paired_fill(tables)
        t2 = time.perf_counter()
        self.stats["call_s"] += t2 - t1
        self.stats["dispatches"] += 1
        self.stats["cells"] += int(
            t["tile_col_len"].astype(np.int64).sum()) * TILE_LANES \
            * t["m"]
        self.stats["lanes"] += len(t["col_idx"])
        self.stats["dispatch_host_s"] += t2 - t_host
        return out, t["layout"]

    def score_pairs_device(self, reads_per_pair):
        """Launch every chunk without fetching; finalize_pairs() later."""
        pending = []
        for chunk_i, idxs in enumerate(self.chunk_pairs):
            out, layout = self._dispatch(
                chunk_i, [reads_per_pair[p] for p in idxs])
            pending.append((chunk_i, idxs, out, layout))
        return pending, len(reads_per_pair)

    def score_pairs(self, reads_per_pair):
        """Per pair (f_out, r_out); each is a (score, end_node, end_ref,
        end_read, multi) tuple of numpy arrays over 2n reads in the
        [fwd + revcomp] / [their reversals] order."""
        return self.finalize_pairs(
            self.score_pairs_device(reads_per_pair))

    def finalize_pairs(self, handle):
        pending, n_pairs = handle
        results = [None] * n_pairs
        t0 = time.perf_counter()
        vals_list = [out.cpu().numpy() for _, _, out, _ in pending]
        self.stats["device_wait_s"] += time.perf_counter() - t0
        for (chunk_i, idxs, _, layout), vals in zip(pending, vals_list):
            slice_pair_outputs(self.chunk_arrays[chunk_i], vals, layout,
                               idxs, results)
        return results

    def engine_report(self) -> dict:
        """Issued DP cells, host-blocking device wait and cells per
        second of that wait. The wait is a lower bound on device time
        when finalize overlaps host work, so cells_per_wait_s is an
        upper bound on the fill's throughput."""
        wait = self.stats["device_wait_s"]
        return {**self.stats,
                "cells_per_wait_s": self.stats["cells"] / wait
                if wait > 0 else 0.0}


class MultiGraphSW:
    """Score (graph, reads) pairs for a batch of events, one fill launch
    per chunk of at most ``col_budget`` columns, on reads expanded on the
    host (the JAX package's ``MultiGraphSW``, through multi_fill).

    Every chunk's launch is issued before the first fetch, and each
    chunk's output comes back as one [4, B] copy. Each event's reads take
    whole tiles of ``tile_batch`` lanes (an event without reads takes one
    tile of pad reads); the JAX scorer's power-of-two tile bucket, which
    only added pad tiles, is gone.
    """

    COL_BUDGET = 12288

    def __init__(self, graphs: Sequence[SequenceGraph],
                 tile_batch: int = TILE_LANES, device="cuda",
                 col_budget: int = COL_BUDGET):
        from .. import resolve_device

        if tile_batch <= 0 or tile_batch % LANES_PER_BLOCK:
            raise ValueError(f"tile_batch {tile_batch} is not a multiple "
                             f"of {LANES_PER_BLOCK}")
        self.device = resolve_device(device)
        self.tile_batch = tile_batch
        gas = [GraphArrays.build(g) for g in graphs]
        n_max = max(a.num_nodes for a in gas)
        p_max = max(a.pred_table.shape[1] for a in gas)
        self.chunk_events: List[List[int]] = []
        cur: List[int] = []
        cur_cols = 0
        for i, ga in enumerate(gas):
            cols = len(ga.ref_codes)
            if cur and cur_cols + cols > col_budget:
                self.chunk_events.append(cur)
                cur, cur_cols = [], 0
            cur.append(i)
            cur_cols += cols
        if cur:
            self.chunk_events.append(cur)
        self.chunk_arrays = [
            MultiGraphArrays(None, prebuilt=[gas[i] for i in idxs],
                             n_max=n_max, p_max=p_max)
            for idxs in self.chunk_events]
        self._chunk_dev = [graph_tensors(a, self.device)
                           for a in self.chunk_arrays]

    def tables(self, chunk_i: int, reads_per_event, pad_to: int = 0):
        """(MultiFillTables, per-event (start lane, n)) of one chunk's
        launch."""
        a = self.chunk_arrays[chunk_i]
        tb = self.tile_batch
        all_reads: List[str] = []
        tile_event: List[int] = []
        event_slices = []
        max_len = 1
        for ev, reads in enumerate(reads_per_event):
            n = len(reads)
            n_pad = _bucket(max(1, n), tb)
            event_slices.append((len(all_reads), n))
            all_reads.extend(reads)
            all_reads.extend(["A"] * (n_pad - n))
            tile_event.extend([ev] * (n_pad // tb))
            if n:
                max_len = max(max_len, max(len(r) for r in reads))
        codes, lens, vlens = encode_reads(
            all_reads, max(pad_to, _bucket(max_len, 32)))
        tile_event = np.asarray(tile_event, np.int32)
        tables = MultiFillTables(
            *self._chunk_dev[chunk_i],
            tile_col_start=_to_device(
                np.asarray(a.col_start, np.int32)[tile_event], self.device),
            tile_col_len=_to_device(
                np.asarray(a.col_len, np.int32)[tile_event], self.device),
            tile_event=_to_device(tile_event, self.device),
            read_codes_t=_to_device(codes.T.astype(np.int8), self.device),
            lens=_to_device(lens[None, :], self.device),
            vlens=_to_device(vlens[None, :], self.device),
            l_ev=_bucket(max(a.col_len), 256))
        return tables, event_slices

    def score(self, reads_per_event: Sequence[List[str]], pad_to: int = 0):
        """Per event, (score, end_node, end_ref, end_read, multi) numpy
        arrays over its reads."""
        pending = []
        for chunk_i, idxs in enumerate(self.chunk_events):
            tables, event_slices = self.tables(
                chunk_i, [reads_per_event[e] for e in idxs], pad_to)
            pending.append((multi_fill(tables), event_slices))
        results = [None] * len(reads_per_event)
        for idxs, a, (out, event_slices) in zip(
                self.chunk_events, self.chunk_arrays, pending):
            score, end_col, end_read, multi = out.cpu().numpy()
            valid = end_col >= 0
            safe_col = np.where(valid, end_col, 0)
            end_node = np.where(
                valid, a.col_node[safe_col], 0).astype(np.int32)
            end_ref = np.where(
                valid, a.col_in_node[safe_col], -1).astype(np.int32)
            chunk_out = (score, end_node, end_ref, end_read, multi)
            for (start, n), e in zip(event_slices, idxs):
                results[e] = tuple(x[start:start + n] for x in chunk_out)
        return results
