"""CRAM 2.1/3.0 reading: targeted region queries and mate lookup, htslib-free.

The reference reads CRAM through htslib (``common::BamReader``,
the reference's src/c++/lib/common/BamReader.cpp — ``hts_open`` accepts both
BAM and CRAM). This module gives ``paragraph_tpu`` the same capability with a
pure-Python decoder exposing the exact ``BamReader`` API, yielding the same
``BamRecord`` objects (paragraph_tpu/io/bam.py).

Wire-format semantics follow the CRAM 3.0 specification as produced/consumed
by htslib 1.9 (the reference's pinned htslib, the reference's external/
htslib-1.9.tar.gz): container/block layout (cram/cram_io.c), compression
header, slice header and record decode order (cram/cram_decode.c), codec
parameter formats (cram/cram_codecs.c) and the rANS 4x8 entropy coder
(cram/rANS_static.c). Differentially tested against htslib-written CRAMs in
tests/test_cram.py (fixtures generated by tests/tools/bam2cram.c).

Supported: gzip/bzip2/lzma/rANS-4x8 block compression; EXTERNAL, HUFFMAN,
BETA, GAMMA, SUBEXP, BYTE_ARRAY_LEN and BYTE_ARRAY_STOP codecs; reference-
based, no-ref and embedded-ref sequence reconstruction; multi-ref slices;
.crai region queries; within-slice and detached mate resolution.
"""
from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .bam import BamRecord, FLAG_PAIRED, FLAG_UNMAPPED, FLAG_MATE_UNMAPPED, \
    FLAG_REVERSE, FLAG_MATE_REVERSE, FLAG_FIRST_MATE

# Block compression methods
_RAW, _GZIP, _BZIP2, _LZMA, _RANS = 0, 1, 2, 3, 4
# Block content types
_FILE_HEADER, _COMPRESSION_HEADER, _MAPPED_SLICE, _EXTERNAL, _CORE = 0, 1, 2, 4, 5

# CRAM record flags (CF series; cram_structs.h CRAM_FLAG_*)
_CF_QUAL = 0x1
_CF_DETACHED = 0x2
_CF_MATE_DOWNSTREAM = 0x4
_CF_NO_SEQ = 0x8

# Mate flags (MF series)
_MF_MATE_REVERSE = 0x1
_MF_MATE_UNMAPPED = 0x2

_INT_MIN = -(1 << 31)

_BASE_ROW = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T; everything else row 4 (N)


# ---------------------------------------------------------------------------
# Primitive readers

class ByteStream:
    """Sequential reader with ITF8/LTF8 support over a bytes-like buffer."""

    __slots__ = ("data", "pos")

    def __init__(self, data, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        p = self.pos
        self.pos = p + n
        out = bytes(self.data[p:self.pos])
        if len(out) != n:
            raise EOFError("CRAM: truncated stream")
        return out

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def itf8(self) -> int:
        """Variable-length int32 (CRAM spec §2.3)."""
        b0 = self.byte()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.byte()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.byte() << 8) | self.byte()
        elif b0 < 0xF0:
            v = ((b0 & 0x1F) << 24) | (self.byte() << 16) | (self.byte() << 8) \
                | self.byte()
        else:
            v = ((b0 & 0x0F) << 28) | (self.byte() << 20) | (self.byte() << 12) \
                | (self.byte() << 4) | (self.byte() & 0x0F)
        # values are signed 32-bit
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        """Variable-length int64 (CRAM spec §2.3)."""
        b0 = self.byte()
        n_extra = 0
        mask = 0x80
        while n_extra < 8 and (b0 & mask):
            n_extra += 1
            mask >>= 1
        if n_extra < 8:
            v = b0 & (0xFF >> n_extra)
        else:
            v = 0
        for _ in range(n_extra):
            v = (v << 8) | self.byte()
        return v - (1 << 64) if v >= (1 << 63) else v

    def int32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def uint32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def eof(self) -> bool:
        return self.pos >= len(self.data)


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("data", "byte_pos", "bit")

    def __init__(self, data):
        self.data = data
        self.byte_pos = 0
        self.bit = 7

    def get_bit(self) -> int:
        b = (self.data[self.byte_pos] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.byte_pos += 1
        else:
            self.bit -= 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v


# ---------------------------------------------------------------------------
# rANS 4x8 (cram/rANS_static.c): TOTFREQ 4096, 4 interleaved byte states

_RANS_L = 1 << 23
_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT


def _rans_read_freqs(stream: ByteStream, order1: bool = False):
    """RLE'd symbol frequency table shared by order-0/order-1 coders.

    Returns (cum_starts[256], freqs[256], lookup[4096] sym-by-slot).
    In order-1 tables a stored frequency of 0 means TOTFREQ (a context
    with a single successor symbol; rANS_static.c:624) — applied here,
    before the lookup fill and the total check, so spec-valid writers
    that encode 4096 as 0 decode (htslib-1.9 itself emits the two-byte
    form)."""
    start = [0] * 256
    freq = [0] * 256
    lookup = bytearray(_TOTFREQ)
    x = 0
    rle = 0
    j = stream.byte()
    while True:
        f = stream.byte()
        if f >= 128:
            f = ((f & 127) << 8) | stream.byte()
        if order1 and f == 0:
            f = _TOTFREQ
        start[j] = x
        freq[j] = f
        if x + f > _TOTFREQ:
            raise ValueError("rANS: frequency overflow")
        for k in range(x, x + f):
            lookup[k] = j
        x += f
        nxt = stream.data[stream.pos]
        if not rle and j + 1 == nxt:
            j = stream.byte()
            rle = stream.byte()
        elif rle:
            rle -= 1
            j += 1
        else:
            j = stream.byte()
        if j == 0:
            break
    if x < _TOTFREQ - 1 or x > _TOTFREQ:
        raise ValueError("rANS: bad frequency total")
    if x < _TOTFREQ:
        lookup[x] = lookup[x - 1]  # historical 4095 fill
    return start, freq, lookup


def rans_decode(data: bytes) -> bytes:
    """Decode one rANS-4x8 compressed buffer (order 0 or 1)."""
    order = data[0]
    comp_sz, out_sz = struct.unpack_from("<II", data, 1)
    s = ByteStream(data, 9)
    out = bytearray(out_sz)
    if order == 0:
        start, freq, lookup = _rans_read_freqs(s)
        R = [s.uint32() for _ in range(4)]
        pos = s.pos
        d = data
        mask = _TOTFREQ - 1
        for i in range(out_sz):
            k = i & 3
            r = R[k]
            m = r & mask
            c = lookup[m]
            out[i] = c
            r = freq[c] * (r >> _TF_SHIFT) + m - start[c]
            while r < _RANS_L and pos < len(d):
                r = (r << 8) | d[pos]
                pos += 1
            R[k] = r
        return bytes(out)
    if order != 1:
        raise ValueError(f"rANS: unknown order {order}")
    # order-1: per-context tables, 4 states over 4 quarters of the output
    starts: Dict[int, list] = {}
    freqs: Dict[int, list] = {}
    lookups: Dict[int, bytearray] = {}
    rle_i = 0
    i = s.byte()
    while True:
        st, fr, lk = _rans_read_freqs(s, order1=True)
        starts[i], freqs[i], lookups[i] = st, fr, lk
        nxt = s.data[s.pos]
        if not rle_i and i + 1 == nxt:
            i = s.byte()
            rle_i = s.byte()
        elif rle_i:
            rle_i -= 1
            i += 1
        else:
            i = s.byte()
        if i == 0:
            break
    R = [s.uint32() for _ in range(4)]
    pos = s.pos
    d = data
    mask = _TOTFREQ - 1
    isz4 = out_sz >> 2
    ctx = [0, 0, 0, 0]
    empty = bytearray(_TOTFREQ)
    zero_start = [0] * 256
    tot_freq = [_TOTFREQ] * 256
    for i in range(isz4):
        for k in range(4):
            r = R[k]
            m = r & mask
            l = ctx[k]
            c = lookups.get(l, empty)[m]
            out[k * isz4 + i] = c
            fr = freqs.get(l, tot_freq)[c]
            st = starts.get(l, zero_start)[c]
            r = fr * (r >> _TF_SHIFT) + m - st
            while r < _RANS_L and pos < len(d):
                r = (r << 8) | d[pos]
                pos += 1
            R[k] = r
            ctx[k] = c
    # remainder handled by state 3
    l = ctx[3]
    r = R[3]
    for i in range(4 * isz4, out_sz):
        m = r & mask
        c = lookups.get(l, empty)[m]
        out[i] = c
        fr = freqs.get(l, tot_freq)[c]
        st = starts.get(l, zero_start)[c]
        r = fr * (r >> _TF_SHIFT) + m - st
        while r < _RANS_L and pos < len(d):
            r = (r << 8) | d[pos]
            pos += 1
        l = c
    return bytes(out)


# ---------------------------------------------------------------------------
# Blocks and containers

class Block:
    __slots__ = ("method", "content_type", "content_id", "data")

    def __init__(self, method, content_type, content_id, data):
        self.method = method
        self.content_type = content_type
        self.content_id = content_id
        self.data = data


def _uncompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == _RAW:
        return data
    if method == _GZIP:
        return zlib.decompress(data, zlib.MAX_WBITS | 32)
    if method == _BZIP2:
        return bz2.decompress(data)
    if method == _LZMA:
        return lzma.decompress(data)
    if method == _RANS:
        return rans_decode(data)
    raise ValueError(f"CRAM: unknown compression method {method}")


def read_block(s: ByteStream, major: int) -> Block:
    hdr_start = s.pos
    method = s.byte()
    content_type = s.byte()
    content_id = s.itf8()
    comp_size = s.itf8()
    raw_size = s.itf8()
    hdr = bytes(s.data[hdr_start:s.pos])
    payload = s.read(comp_size if method != _RAW else raw_size)
    if major >= 3:
        crc = s.uint32()
        actual = zlib.crc32(hdr + payload) & 0xFFFFFFFF
        if crc != actual:
            raise ValueError("CRAM: block CRC32 mismatch")
    data = _uncompress(method, payload, raw_size)
    if len(data) != raw_size:
        raise ValueError("CRAM: block size mismatch after decompression")
    return Block(method, content_type, content_id, data)


class ContainerHeader:
    __slots__ = ("length", "ref_seq_id", "ref_seq_start", "ref_seq_span",
                 "num_records", "record_counter", "num_bases", "num_blocks",
                 "landmarks", "data_start")

    def is_eof(self) -> bool:
        return (self.num_records == 0 and self.ref_seq_id == -1
                and self.ref_seq_start == 0x454F46)  # "EOF"


def read_container_header(s: ByteStream, major: int) -> ContainerHeader:
    h = ContainerHeader()
    hdr_start = s.pos
    h.length = s.int32()
    crc_start = s.pos
    h.ref_seq_id = s.itf8()
    h.ref_seq_start = s.itf8()
    h.ref_seq_span = s.itf8()
    h.num_records = s.itf8()
    if major >= 3:
        h.record_counter = s.ltf8()
    else:
        h.record_counter = s.itf8()
    h.num_bases = s.ltf8()
    h.num_blocks = s.itf8()
    n_landmarks = s.itf8()
    h.landmarks = [s.itf8() for _ in range(n_landmarks)]
    if major >= 3:
        crc = s.uint32()
        hdr_bytes = bytes(s.data[hdr_start:hdr_start + 4]) + \
            bytes(s.data[crc_start:s.pos - 4])
        if crc != zlib.crc32(hdr_bytes) & 0xFFFFFFFF:
            raise ValueError("CRAM: container header CRC32 mismatch")
    h.data_start = s.pos
    return h


# ---------------------------------------------------------------------------
# Codecs (cram/cram_codecs.c parameter formats)

E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA, E_SUBEXP = 4, 5, 6, 7
E_GOLOMB_RICE, E_GAMMA = 8, 9


class Codec:
    """One decoder for a data series: reads ints or byte arrays from the
    core bit stream / external block cursors of a slice."""

    def __init__(self, kind: int, params: ByteStream):
        self.kind = kind
        if kind == E_EXTERNAL:
            self.content_id = params.itf8()
        elif kind == E_HUFFMAN:
            ncodes = params.itf8()
            symbols = [params.itf8() for _ in range(ncodes)]
            nlens = params.itf8()
            if nlens != ncodes:
                raise ValueError("CRAM: malformed huffman parameters")
            lens = [params.itf8() for _ in range(ncodes)]
            codes = sorted(zip(lens, symbols))
            # canonical code assignment (cram_huffman_decode_init)
            table: Dict[Tuple[int, int], int] = {}
            val, last_len = -1, 0
            for ln, sym in codes:
                val += 1
                if ln > last_len:
                    val <<= (ln - last_len)
                    last_len = ln
                table[(ln, val)] = sym
            self.table = table
            self.single = codes[0][1] if len(codes) == 1 and codes[0][0] == 0 \
                else None
            self.max_len = codes[-1][0] if codes else 0
        elif kind == E_BYTE_ARRAY_LEN:
            enc = params.itf8()
            size = params.itf8()
            self.len_codec = Codec(enc, ByteStream(params.read(size)))
            enc = params.itf8()
            size = params.itf8()
            self.val_codec = Codec(enc, ByteStream(params.read(size)))
        elif kind == E_BYTE_ARRAY_STOP:
            self.stop = params.byte()
            self.content_id = params.itf8()
        elif kind == E_BETA:
            self.offset = params.itf8()
            self.nbits = params.itf8()
        elif kind == E_SUBEXP:
            self.offset = params.itf8()
            self.k = params.itf8()
        elif kind == E_GAMMA:
            self.offset = params.itf8()
        elif kind == E_NULL:
            pass
        else:
            raise ValueError(f"CRAM: unsupported codec {kind}")

    def decode_int(self, core: BitReader, ext: Dict[int, ByteStream]) -> int:
        k = self.kind
        if k == E_EXTERNAL:
            return ext[self.content_id].itf8()
        if k == E_HUFFMAN:
            if self.single is not None:
                return self.single
            val, ln = 0, 0
            table = self.table
            while ln <= self.max_len:
                val = (val << 1) | core.get_bit()
                ln += 1
                sym = table.get((ln, val))
                if sym is not None:
                    return sym
            raise ValueError("CRAM: bad huffman code")
        if k == E_BETA:
            return (core.get_bits(self.nbits) if self.nbits else 0) - self.offset
        if k == E_GAMMA:
            nz = 0
            while core.get_bit() == 0:
                nz += 1
            val = 1
            for _ in range(nz):
                val = (val << 1) | core.get_bit()
            return val - self.offset
        if k == E_SUBEXP:
            i = 0
            while core.get_bit() == 1:
                i += 1
            if i:
                val = core.get_bits(i + self.k - 1) + (1 << (i + self.k - 1))
            else:
                val = core.get_bits(self.k)
            return val - self.offset
        raise ValueError(f"CRAM: codec {k} cannot decode ints")

    def decode_bytes(self, core: BitReader, ext: Dict[int, ByteStream],
                     n: Optional[int] = None) -> bytes:
        k = self.kind
        if k == E_EXTERNAL:
            return ext[self.content_id].read(1 if n is None else n)
        if k == E_BYTE_ARRAY_LEN:
            ln = self.len_codec.decode_int(core, ext)
            return self.val_codec.decode_bytes(core, ext, ln)
        if k == E_BYTE_ARRAY_STOP:
            s = ext[self.content_id]
            data = s.data
            p = s.pos
            stop = self.stop
            q = p
            while data[q] != stop:
                q += 1
            s.pos = q + 1
            return bytes(data[p:q])
        if k == E_HUFFMAN:
            return bytes(self.decode_int(core, ext) & 0xFF
                         for _ in range(1 if n is None else n))
        if k == E_BETA:
            return bytes((self.decode_int(core, ext)) & 0xFF
                         for _ in range(1 if n is None else n))
        raise ValueError(f"CRAM: codec {k} cannot decode byte arrays")


# ---------------------------------------------------------------------------
# Compression header

class CompressionHeader:
    def __init__(self, block: Block, major: int):
        s = ByteStream(block.data)
        self.read_names_included = False
        self.ap_delta = True
        self.no_ref = False
        # default substitution matrix "CGTN AGTN ACTN ACGN ACGT"
        self.sub_matrix = ["CGTN", "AGTN", "ACTN", "ACGN", "ACGT"]
        self.tag_lists: List[List[Tuple[str, str]]] = []
        # preservation map
        map_size = s.itf8()
        end = s.pos + map_size
        nkeys = s.itf8()
        for _ in range(nkeys):
            key = s.read(2)
            if key == b"RN":
                self.read_names_included = bool(s.byte())
            elif key == b"AP":
                self.ap_delta = bool(s.byte())
            elif key == b"RR":
                self.no_ref = not s.byte()
            elif key in (b"MI", b"UI", b"PI"):
                s.byte()
            elif key == b"SM":
                sm = s.read(5)
                rows = []
                for r, others in enumerate(["CGTN", "AGTN", "ACTN", "ACGN",
                                            "ACGT"]):
                    row = [""] * 4
                    b = sm[r]
                    row[(b >> 6) & 3] = others[0]
                    row[(b >> 4) & 3] = others[1]
                    row[(b >> 2) & 3] = others[2]
                    row[b & 3] = others[3]
                    rows.append("".join(row))
                self.sub_matrix = rows
            elif key == b"TD":
                blk_size = s.itf8()
                td = s.read(blk_size)
                if td and td[-1] != 0:
                    td += b"\x00"
                for entry in td.split(b"\x00")[:-1] if td else []:
                    tags = [(entry[i:i + 2].decode("latin-1"),
                             chr(entry[i + 2]))
                            for i in range(0, len(entry), 3)]
                    self.tag_lists.append(tags)
                if not td:
                    self.tag_lists = [[]]
            else:
                # unknown keys have unknown value widths; guessing one
                # byte would desynchronize the remaining keys (SM/TD
                # could be silently misread) — fail loudly instead
                raise ValueError(
                    "CRAM: unknown preservation-map key "
                    f"{key!r} (cannot infer value size)")
        s.pos = end
        if not self.tag_lists:
            self.tag_lists = [[]]
        # data series encoding map
        self.codecs: Dict[str, Codec] = {}
        map_size = s.itf8()
        end = s.pos + map_size
        nkeys = s.itf8()
        for _ in range(nkeys):
            key = s.read(2).decode("latin-1")
            enc = s.itf8()
            size = s.itf8()
            params = ByteStream(s.read(size))
            if enc != E_NULL:
                self.codecs[key] = Codec(enc, params)
        s.pos = end
        # tag encoding map
        self.tag_codecs: Dict[int, Codec] = {}
        map_size = s.itf8()
        end = s.pos + map_size
        nkeys = s.itf8()
        for _ in range(nkeys):
            tag_id = s.itf8()
            enc = s.itf8()
            size = s.itf8()
            params = ByteStream(s.read(size))
            self.tag_codecs[tag_id] = Codec(enc, params)
        s.pos = end


# ---------------------------------------------------------------------------
# Slice decoding

class SliceHeader:
    __slots__ = ("ref_seq_id", "ref_seq_start", "ref_seq_span", "num_records",
                 "record_counter", "num_blocks", "content_ids", "ref_base_id",
                 "md5")


def read_slice_header(block: Block, major: int) -> SliceHeader:
    s = ByteStream(block.data)
    h = SliceHeader()
    h.ref_seq_id = s.itf8()
    h.ref_seq_start = s.itf8()
    h.ref_seq_span = s.itf8()
    h.num_records = s.itf8()
    h.record_counter = s.ltf8() if major >= 3 else s.itf8()
    h.num_blocks = s.itf8()
    n_ids = s.itf8()
    h.content_ids = [s.itf8() for _ in range(n_ids)]
    h.ref_base_id = s.itf8()
    h.md5 = s.read(16) if major >= 2 else b"\x00" * 16
    return h


def _decode_features(comp: CompressionHeader, core, ext, read_len: int,
                     apos: int, get_ref: Optional[Callable[[int], int]]):
    """Decode the FN/FC/FP feature stream into (bases, cigar, aend).

    Mirrors cram_decode_seq (cram/cram_decode.c:1199-1905): positions are
    1-based along the read; implicit match segments copy reference bases
    through the substitution matrix convention; returns phred quals only via
    the Q/q features (full QS arrays are read by the caller)."""
    codecs = comp.codecs
    seq = bytearray(b"=" * read_len)
    qual = bytearray(b"\xff" * read_len)
    fn = codecs["FN"].decode_int(core, ext)
    cigar: List[Tuple[int, int]] = []
    cig_op, cig_len = 0, 0  # M
    seq_pos = 1  # 1-based
    ref_pos = apos - 1  # 0-based
    prev_pos = 0

    def flush(new_op):
        nonlocal cig_op, cig_len
        if cig_len and cig_op != new_op:
            cigar.append((cig_op, cig_len))
            cig_len = 0
        cig_op = new_op

    def fill_ref(start_seq_pos, count):
        if get_ref is not None:
            for i in range(count):
                seq[start_seq_pos - 1 + i] = get_ref(ref_pos + i)

    for _ in range(fn):
        op = codecs["FC"].decode_bytes(core, ext)[0:1].decode("latin-1")
        pos = codecs["FP"].decode_int(core, ext) + prev_pos
        if pos > seq_pos:
            gap = pos - seq_pos
            fill_ref(seq_pos, gap)
            flush(0)
            cig_len += gap
            ref_pos += gap
            seq_pos = pos
        prev_pos = pos
        if op == "B":  # base + qual
            flush(0)
            seq[pos - 1] = codecs["BA"].decode_bytes(core, ext)[0]
            qual[pos - 1] = codecs["QS"].decode_bytes(core, ext)[0]
            cig_len += 1
            seq_pos += 1
            ref_pos += 1
        elif op == "X":  # substitution
            flush(0)
            code = codecs["BS"].decode_bytes(core, ext)[0]
            if get_ref is None:
                row = 4
            else:
                row = _BASE_ROW.get(get_ref(ref_pos), 4)
            seq[pos - 1] = ord(comp.sub_matrix[row][code])
            cig_len += 1
            seq_pos += 1
            ref_pos += 1
        elif op == "I":  # insertion
            flush(1)
            ins = codecs["IN"].decode_bytes(core, ext)
            seq[pos - 1:pos - 1 + len(ins)] = ins
            cig_len += len(ins)
            seq_pos += len(ins)
        elif op == "i":  # single-base insertion
            flush(1)
            seq[pos - 1] = codecs["BA"].decode_bytes(core, ext)[0]
            cig_len += 1
            seq_pos += 1
        elif op == "D":  # deletion
            flush(2)
            dl = codecs["DL"].decode_int(core, ext)
            cig_len += dl
            ref_pos += dl
        elif op == "N":  # ref skip
            flush(3)
            rs = codecs["RS"].decode_int(core, ext)
            cig_len += rs
            ref_pos += rs
        elif op == "S":  # soft clip
            flush(4)
            sc = codecs["SC"].decode_bytes(core, ext)
            seq[pos - 1:pos - 1 + len(sc)] = sc
            cigar.append((4, len(sc)))
            cig_len = 0
            seq_pos += len(sc)
        elif op == "H":  # hard clip
            flush(5)
            cig_len += codecs["HC"].decode_int(core, ext)
        elif op == "P":  # padding
            flush(6)
            cig_len += codecs["PD"].decode_int(core, ext)
        elif op == "b":  # verbatim bases
            flush(0)
            bb = codecs["BB"].decode_bytes(core, ext)
            seq[pos - 1:pos - 1 + len(bb)] = bb
            cig_len += len(bb)
            seq_pos += len(bb)
            ref_pos += len(bb)
        elif op == "q":  # verbatim quals
            flush(0)
            qq = codecs["QQ"].decode_bytes(core, ext)
            qual[pos - 1:pos - 1 + len(qq)] = qq
            cig_len += len(qq)
            seq_pos += len(qq)
            ref_pos += len(qq)
        elif op == "Q":  # single qual
            qual[pos - 1] = codecs["QS"].decode_bytes(core, ext)[0]
        else:
            raise ValueError(f"CRAM: unknown feature code {op!r}")
    # implicit trailing match
    if read_len >= seq_pos:
        tail = read_len - seq_pos + 1
        fill_ref(seq_pos, tail)
        flush(0)
        cig_len += tail
        ref_pos += tail
    if cig_len:
        cigar.append((cig_op, cig_len))
    return seq, qual, cigar, ref_pos


class _CramRec:
    __slots__ = ("flags", "cram_flags", "ref_id", "read_len", "apos", "aend",
                 "name", "mate_flags", "mate_ref_id", "mate_pos", "tlen",
                 "mate_line", "mapq", "bases", "quals", "cigar")


def _synthesize_read_names(recs, record_counter: int) -> None:
    """RN=false leaves non-detached records nameless; synthesize
    deterministic names from the slice's global record counter so mate
    lookup by fragment_id stays sound, sharing the chain head's name
    across within-slice mate chains (htslib cram_decode.c does the same
    with its "%s:%ld" prefix+counter names)."""
    for rec_idx, cr in enumerate(recs):
        if cr.name:
            continue
        name = f"paragraph:{record_counter + rec_idx}"
        j = rec_idx
        while 0 <= j < len(recs) and not recs[j].name:
            recs[j].name = name
            j = recs[j].mate_line


def decode_slice(comp: CompressionHeader, hdr: SliceHeader, blocks: List[Block],
                 get_contig: Callable[[int], Optional[bytes]],
                 major: int) -> List[BamRecord]:
    """Decode all records of one slice into BamRecords.

    Follows the record layout of cram_decode_slice (cram/cram_decode.c:2297+)
    and resolves within-slice mate chains like cram_decode_slice_xref."""
    core = None
    ext: Dict[int, ByteStream] = {}
    for b in blocks:
        if b.content_type == _CORE:
            core = BitReader(b.data)
        elif b.content_type == _EXTERNAL:
            ext[b.content_id] = ByteStream(b.data)
    codecs = comp.codecs

    embedded_ref: Optional[bytes] = None
    if hdr.ref_base_id >= 0 and hdr.ref_base_id in ext:
        embedded_ref = ext[hdr.ref_base_id].data

    ref_cache: Dict[int, Optional[bytes]] = {}

    def ref_getter(ref_id: int) -> Optional[Callable[[int], int]]:
        # embedded reference wins even when RR=false (htslib EMBED_REF mode
        # writes RR=0 but stores the slice reference in-band)
        if embedded_ref is not None:
            base0 = hdr.ref_seq_start - 1
            emb = embedded_ref
            return lambda p: emb[p - base0] if 0 <= p - base0 < len(emb) else 78
        if comp.no_ref or ref_id < 0:
            return None
        if ref_id not in ref_cache:
            ref_cache[ref_id] = get_contig(ref_id)
        contig = ref_cache[ref_id]
        if contig is None:
            return None
        return lambda p: contig[p] if 0 <= p < len(contig) else 78

    recs: List[_CramRec] = []
    last_apos = hdr.ref_seq_start
    for rec_idx in range(hdr.num_records):
        cr = _CramRec()
        bf = codecs["BF"].decode_int(core, ext)
        cf = codecs["CF"].decode_int(core, ext) if "CF" in codecs else 0
        cr.cram_flags = cf
        if hdr.ref_seq_id == -2:
            cr.ref_id = codecs["RI"].decode_int(core, ext) if "RI" in codecs \
                else -1
        else:
            cr.ref_id = hdr.ref_seq_id
        cr.read_len = codecs["RL"].decode_int(core, ext)
        apos = codecs["AP"].decode_int(core, ext)
        if comp.ap_delta:
            apos += last_apos
        last_apos = apos
        cr.apos = apos
        if "RG" in codecs:
            codecs["RG"].decode_int(core, ext)
        cr.name = ""
        if comp.read_names_included and "RN" in codecs:
            cr.name = codecs["RN"].decode_bytes(core, ext).decode("latin-1")
        cr.mate_pos = 0
        cr.mate_line = -1
        cr.mate_ref_id = -1
        cr.mate_flags = 0
        cr.tlen = _INT_MIN
        if cf & _CF_DETACHED:
            cr.mate_flags = codecs["MF"].decode_int(core, ext) \
                if "MF" in codecs else 0
            if not comp.read_names_included and "RN" in codecs:
                cr.name = codecs["RN"].decode_bytes(core, ext).decode("latin-1")
            if "NS" in codecs:
                cr.mate_ref_id = codecs["NS"].decode_int(core, ext)
            if "NP" in codecs:
                cr.mate_pos = codecs["NP"].decode_int(core, ext)
            if "TS" in codecs:
                cr.tlen = codecs["TS"].decode_int(core, ext)
        elif cf & _CF_MATE_DOWNSTREAM:
            nf = codecs["NF"].decode_int(core, ext)
            cr.mate_line = rec_idx + 1 + nf
        # aux tags (decoded to keep stream cursors in sync; values unused)
        if "TL" in codecs:
            tl = codecs["TL"].decode_int(core, ext)
            for tag, typ in comp.tag_lists[tl]:
                tag_id = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                comp.tag_codecs[tag_id].decode_bytes(core, ext)
        # sequence
        if not (bf & FLAG_UNMAPPED):
            get_ref = ref_getter(cr.ref_id)
            seq, qual, cigar, aend = _decode_features(
                comp, core, ext, cr.read_len, cr.apos, get_ref)
            cr.aend = aend
            cr.mapq = codecs["MQ"].decode_int(core, ext) if "MQ" in codecs \
                else 40
            if cf & _CF_QUAL and "QS" in codecs:
                qual = bytearray(
                    codecs["QS"].decode_bytes(core, ext, cr.read_len))
            cr.bases = seq.decode("latin-1")
            cigar = cigar
        else:
            cr.aend = cr.apos
            cr.mapq = 0
            cigar = []
            seq = bytearray(b"=" * cr.read_len)
            if "BA" in codecs and cr.read_len:
                seq = bytearray(
                    codecs["BA"].decode_bytes(core, ext, cr.read_len))
            if cf & _CF_QUAL and "QS" in codecs:
                qual = bytearray(
                    codecs["QS"].decode_bytes(core, ext, cr.read_len))
            else:
                qual = bytearray(b"\xff" * cr.read_len)
            cr.bases = seq.decode("latin-1")
        cr.flags = bf
        if cf & _CF_NO_SEQ:
            cr.read_len = 0
            cr.bases = ""
            qual = bytearray()
        cr.quals = bytes(qual)
        cr.cigar = cigar
        recs.append(cr)

    # mate resolution within the slice (cram_decode_slice_xref)
    for rec_idx, cr in enumerate(recs):
        if cr.mate_line >= 0:
            if cr.mate_line >= len(recs):
                raise ValueError("CRAM: mate line out of bounds")
            if cr.tlen == _INT_MIN:
                id1 = id2 = rec_idx
                aleft, aright = cr.apos, cr.aend
                left_cnt = 0
                ref = cr.ref_id
                while True:
                    o = recs[id2]
                    if aleft > o.apos:
                        aleft, left_cnt = o.apos, 1
                    elif aleft == o.apos:
                        left_cnt += 1
                    if aright < o.aend:
                        aright = o.aend
                    if o.mate_line == -1:
                        o.mate_line = rec_idx
                        break
                    id2 = o.mate_line
                    if recs[id2].ref_id != ref:
                        ref = -1
                    if id2 == id1:
                        break
                if ref != -1:
                    tlen = aright - aleft + 1
                    id2 = rec_idx
                    while True:
                        o = recs[id2]
                        if o.apos == aleft and (left_cnt == 1 or
                                                (o.flags & FLAG_FIRST_MATE)):
                            o.tlen = tlen
                        else:
                            o.tlen = -tlen
                        id2 = o.mate_line
                        if id2 == rec_idx:
                            break
                else:
                    id2 = rec_idx
                    while True:
                        recs[id2].tlen = 0
                        id2 = recs[id2].mate_line
                        if id2 == rec_idx:
                            break
            mate = recs[cr.mate_line]
            cr.mate_pos = mate.apos
            cr.mate_ref_id = mate.ref_id
            cr.flags |= FLAG_PAIRED
            if mate.flags & FLAG_UNMAPPED:
                cr.flags |= FLAG_MATE_UNMAPPED
                cr.tlen = 0
            if cr.flags & FLAG_UNMAPPED:
                cr.tlen = 0
            if mate.flags & FLAG_REVERSE:
                cr.flags |= FLAG_MATE_REVERSE
        else:
            if cr.mate_flags & _MF_MATE_REVERSE:
                cr.flags |= FLAG_PAIRED | FLAG_MATE_REVERSE
            if cr.mate_flags & _MF_MATE_UNMAPPED:
                cr.flags |= FLAG_MATE_UNMAPPED
            if not (cr.flags & FLAG_PAIRED):
                cr.mate_ref_id = -1
        if cr.tlen == _INT_MIN:
            cr.tlen = 0

    if not comp.read_names_included:
        _synthesize_read_names(recs, hdr.record_counter)

    out = []
    for cr in recs:
        if cr.quals and cr.quals[0] == 0xFF:
            quals = "#" * cr.read_len
        else:
            quals = "".join(chr(q + 33) for q in cr.quals)
        out.append(BamRecord(
            fragment_id=cr.name,
            flag=cr.flags & 0xFFFF,
            chrom_id=cr.ref_id,
            pos=cr.apos - 1,
            mapq=cr.mapq,
            cigar=cr.cigar,
            mate_chrom_id=cr.mate_ref_id,
            mate_pos=cr.mate_pos - 1,
            tlen=cr.tlen,
            bases=cr.bases,
            quals=quals,
        ))
    return out


# ---------------------------------------------------------------------------
# CRAI index

class CraiIndex:
    """CRAM index: gzipped text, one line per slice —
    seq_id, 1-based start, span, container offset, slice offset, slice size."""

    def __init__(self, path: str):
        with gzip.open(path, "rt") as f:
            self.entries = []
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 6:
                    self.entries.append(tuple(int(x) for x in parts[:6]))

    def containers_for_region(self, tid: int, beg0: int, end0: int) -> List[int]:
        """Container file offsets whose slices overlap [beg0, end0)."""
        offsets = []
        for seq_id, start, span, c_off, _s_off, _s_size in self.entries:
            if seq_id != tid and seq_id != -2:
                continue
            s0 = start - 1
            if seq_id == -2 or (s0 < end0 and s0 + span > beg0):
                offsets.append(c_off)
        return sorted(set(offsets))


# ---------------------------------------------------------------------------
# Reader

class CramReader:
    """Drop-in CRAM counterpart of ``BamReader`` (same public surface)."""

    #: decoded containers kept resident (LRU); a container is typically
    #: ~1-10k records, so 8 bounds memory at a few MB while still serving
    #: the pipeline's overlapping-region access pattern
    CONTAINER_CACHE_SIZE = 8

    def __init__(self, path: str, index_path: str = "",
                 reference_path: str = ""):
        import mmap

        self.path = path
        self._file = open(path, "rb")
        try:
            # map, don't read: production CRAMs are tens of GB and the
            # reference's htslib reader streams containers on demand
            self._data = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file etc. — fail below
            self._data = self._file.read()
        if self._data[:4] != b"CRAM":
            raise ValueError(f"Not a CRAM file: {path}")
        self.major, self.minor = self._data[4], self._data[5]
        if not (2 <= self.major <= 3):
            raise ValueError(f"Unsupported CRAM version {self.major}.{self.minor}")
        s = ByteStream(self._data, 26)
        # first container: SAM header text (int32 length + text)
        ch = read_container_header(s, self.major)
        hb = read_block(ByteStream(self._data, ch.data_start), self.major)
        hs = ByteStream(hb.data)
        text_len = hs.int32()
        self.header_text = hs.read(text_len).split(b"\x00")[0].decode(
            errors="replace")
        self._first_data_container = ch.data_start + ch.length
        self.contigs: List[Tuple[str, int]] = []
        self.contig_map: Dict[str, int] = {}
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                name, ln = "", 0
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        name = fld[3:]
                    elif fld.startswith("LN:"):
                        ln = int(fld[3:])
                self.contig_map[name] = len(self.contigs)
                self.contigs.append((name, ln))
        self._fasta = None
        if reference_path:
            from .fasta import FastaFile
            self._fasta = FastaFile(reference_path)
        from collections import OrderedDict

        self._contig_cache: Dict[int, Optional[bytes]] = {}
        self._container_cache: "OrderedDict[int, List[BamRecord]]" = \
            OrderedDict()
        try:
            self._index = CraiIndex(index_path or path + ".crai")
        except FileNotFoundError:
            self._index = None

    # -- reference access ---------------------------------------------------

    def _get_contig(self, ref_id: int) -> Optional[bytes]:
        if ref_id in self._contig_cache:
            return self._contig_cache[ref_id]
        seq = None
        if self._fasta is not None and 0 <= ref_id < len(self.contigs):
            name = self.contigs[ref_id][0]
            try:
                seq = self._fasta.fetch(
                    name, 0, self._fasta.contig_length(name)
                ).upper().encode("latin-1")
            except (KeyError, ValueError):
                seq = None
        self._contig_cache[ref_id] = seq
        return seq

    # -- container decoding --------------------------------------------------

    def _decode_container_at(self, offset: int) -> List[BamRecord]:
        cached = self._container_cache.get(offset)
        if cached is not None:
            self._container_cache.move_to_end(offset)
            return cached
        s = ByteStream(self._data, offset)
        ch = read_container_header(s, self.major)
        if ch.is_eof() or ch.num_records == 0:
            self._container_cache[offset] = []
            return []
        comp_block = read_block(s, self.major)
        if comp_block.content_type != _COMPRESSION_HEADER:
            raise ValueError("CRAM: expected compression header block")
        comp = CompressionHeader(comp_block, self.major)
        records: List[BamRecord] = []
        while s.pos < ch.data_start + ch.length:
            blk = read_block(s, self.major)
            if blk.content_type != _MAPPED_SLICE:
                continue
            sh = read_slice_header(blk, self.major)
            blocks = [read_block(s, self.major) for _ in range(sh.num_blocks)]
            records.extend(
                decode_slice(comp, sh, blocks, self._get_contig, self.major))
        self._container_cache[offset] = records
        while len(self._container_cache) > self.CONTAINER_CACHE_SIZE:
            self._container_cache.popitem(last=False)
        return records

    def _container_offsets(self) -> Iterator[int]:
        pos = self._first_data_container
        data = self._data
        major = self.major
        while pos < len(data):
            s = ByteStream(data, pos)
            ch = read_container_header(s, major)
            if ch.is_eof():
                return
            yield pos
            pos = ch.data_start + ch.length

    def records(self) -> Iterator[BamRecord]:
        """All records in file order."""
        for off in self._container_offsets():
            yield from self._decode_container_at(off)

    # -- BamReader-compatible API ---------------------------------------------

    def fetch(self, tid: int, beg: int, end: int,
              primary_only: bool = True) -> Iterator[BamRecord]:
        if self._index is not None:
            offsets = self._index.containers_for_region(tid, beg, end)
        else:
            offsets = list(self._container_offsets())
        for off in offsets:
            for rec in self._decode_container_at(off):
                if rec.chrom_id != tid:
                    continue
                if rec.pos >= end or rec.end_pos() <= beg:
                    continue
                if primary_only and (rec.is_secondary or rec.is_supplementary):
                    continue
                yield rec

    def fetch_region(self, region_str: str, primary_only: bool = True):
        from .regions import parse_region

        chrom, start, end = parse_region(region_str)
        tid = self.contig_map[chrom]
        beg0 = (start - 1) if start else 0
        end0 = end if end else self.contigs[tid][1]
        return self.fetch(tid, beg0, end0, primary_only=primary_only)

    def get_aligned_mate(self, read: BamRecord) -> Optional[BamRecord]:
        if read.is_mate_mapped:
            tid, beg = read.mate_chrom_id, read.mate_pos
        else:
            tid, beg = read.chrom_id, read.pos
        if tid < 0:
            return None
        for rec in self.fetch(tid, beg, beg + 1, primary_only=False):
            if rec.fragment_id == read.fragment_id and \
                    rec.is_first_mate != read.is_first_mate:
                return rec
        return None

    def index_read_counts(self):
        """CRAI carries no per-contig read-count stats (unlike BAI pseudo
        bins); mirror htslib by reporting absence."""
        return [None] * len(self.contigs)

    def unplaced_read_count(self):
        return None

    def close(self):
        import mmap

        if isinstance(self._data, mmap.mmap):
            self._data.close()
        self._data = b""
        self._file.close()
        self._container_cache.clear()


def open_alignment_reader(path: str, index_path: str = "",
                          reference_path: str = ""):
    """Open a BAM or CRAM by content sniffing (hts_open equivalent:
    the reference accepts either container through the same BamReader).

    BAMs start with a BGZF gzip magic; CRAMs with the raw bytes "CRAM"."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"CRAM":
        return CramReader(path, index_path, reference_path)
    from .bam import BamReader
    return BamReader(path, index_path, reference_path)
