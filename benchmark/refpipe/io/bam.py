"""BAM + BAI reading: targeted region queries and mate lookup.

Replaces the reference's htslib-backed ``common::BamReader``
(the reference's src/c++/lib/common/BamReader.cpp). Semantics matched:

- ``set_region`` / iteration yields primary alignments only — supplementary
  (0x800) and secondary (0x100) records are skipped
  (BamReader::SkipToNextGoodAlign, BamReader.cpp:307-326).
- A record is yielded when its alignment span overlaps the query region
  (htslib iterator semantics: 0-based half-open, end from CIGAR reference
  length; unmapped-but-placed reads count with span pos..pos+1).
- ``get_aligned_mate`` queries the mate position and matches fragment id and
  mate order (BamReader::getAlignedMate, BamReader.cpp:328-365).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from .bgzf import BgzfReader

SEQ_CODES = "=ACMGRSVTWYHKDBN"

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST_MATE = 0x40
FLAG_SECOND_MATE = 0x80
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

CIGAR_OPS = "MIDNSHP=X"
# ops that consume reference
_REF_CONSUME = {0, 2, 3, 7, 8}


def _native_scan_lib():
    """Handle of the native runtime library (bam_scan record walker), or
    None when it can't be built. Imported lazily: align.native pulls in
    graph.model, which io code must not require at import time."""
    return None


@dataclass
class BamRecord:
    """Decoded BAM alignment record.

    Field selection mirrors decodeHtsAlign (BamReader.cpp:84-107): the graph
    re-alignment pipeline only needs name/bases/quals/flags/coords, not the
    linear CIGAR (kept anyway for end-position computation and idxdepth).
    """

    fragment_id: str
    flag: int
    chrom_id: int
    pos: int  # 0-based leftmost position
    mapq: int
    cigar: List[Tuple[int, int]]  # (op, len)
    mate_chrom_id: int
    mate_pos: int
    tlen: int
    bases: str
    quals: str  # phred+33 string

    @property
    def is_mapped(self) -> bool:
        return (self.flag & FLAG_UNMAPPED) == 0

    @property
    def is_mate_mapped(self) -> bool:
        return (self.flag & FLAG_MATE_UNMAPPED) == 0

    @property
    def is_reverse_strand(self) -> bool:
        return (self.flag & FLAG_REVERSE) != 0

    @property
    def is_mate_reverse_strand(self) -> bool:
        return (self.flag & FLAG_MATE_REVERSE) != 0

    @property
    def is_first_mate(self) -> bool:
        return (self.flag & FLAG_FIRST_MATE) != 0

    @property
    def is_secondary(self) -> bool:
        return (self.flag & FLAG_SECONDARY) != 0

    @property
    def is_supplementary(self) -> bool:
        return (self.flag & FLAG_SUPPLEMENTARY) != 0

    def reference_length(self) -> int:
        return sum(l for op, l in self.cigar if op in _REF_CONSUME)

    def end_pos(self) -> int:
        """0-based exclusive end (bam_endpos: pos+1 when no ref-consuming ops)."""
        rlen = self.reference_length()
        return self.pos + (rlen if rlen > 0 else 1)


# nibble codes → bases via the C-speed hex()/str.translate pair: each seq
# byte hex-prints to two digits, and each hex digit is one 4-bit base code
_HEX_TO_BASE = str.maketrans("0123456789abcdef", SEQ_CODES)
_QUAL_TO_CHAR = bytes(min(q + 33, 255) for q in range(256))


def _decode_record(data: bytes) -> BamRecord:
    (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, next_refid,
     next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    name = data[off:off + l_read_name - 1].decode()
    off += l_read_name
    if n_cigar:
        cigar = [(v & 0xF, v >> 4)
                 for v in struct.unpack_from(f"<{n_cigar}I", data, off)]
        off += 4 * n_cigar
    else:
        cigar = []
    nbytes = (l_seq + 1) // 2
    seq_raw = data[off:off + nbytes]
    off += nbytes
    bases = seq_raw.hex().translate(_HEX_TO_BASE)[:l_seq]
    quals_raw = data[off:off + l_seq]
    off += l_seq
    if l_seq and quals_raw[0] == 0xFF:
        quals = "#" * l_seq
    else:
        quals = quals_raw.translate(_QUAL_TO_CHAR).decode("latin-1")
    return BamRecord(
        fragment_id=name,
        flag=flag,
        chrom_id=refid,
        pos=pos,
        mapq=mapq,
        cigar=cigar,
        mate_chrom_id=next_refid,
        mate_pos=next_pos,
        tlen=tlen,
        bases=bases,
        quals=quals,
    )


def _reg2bins(beg: int, end: int) -> List[int]:
    """Candidate bins overlapping [beg, end) for the standard 6-level scheme."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"Not a BAI file: {path}")
        off = 4
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.refs = []
        # per-ref (mapped, unmapped) from the 37450 pseudo bin
        # (hts_idx_get_stat equivalent)
        self.stats = []
        for _ in range(n_ref):
            bins = {}
            stat = None
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                if bin_id == 37450 and len(chunks) == 2:
                    stat = (chunks[1][0], chunks[1][1])
                else:
                    bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            ioffsets = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.refs.append((bins, ioffsets))
            self.stats.append(stat)
        self.n_no_coor = None
        if off + 8 <= len(data):
            self.n_no_coor = struct.unpack_from("<Q", data, off)[0]

    def chunks_for_region(self, tid: int, beg: int, end: int):
        if tid < 0 or tid >= len(self.refs):
            return []
        bins, ioffsets = self.refs[tid]
        # linear index lower bound
        window = beg >> 14
        min_off = 0
        if ioffsets:
            if window < len(ioffsets):
                min_off = ioffsets[window]
            elif ioffsets:
                min_off = ioffsets[-1]
        chunks = []
        for b in _reg2bins(beg, end):
            if b in bins:
                for cbeg, cend in bins[b]:
                    if cend > min_off:
                        chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        # merge adjacent/overlapping chunks
        merged = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
            else:
                merged.append(list(c) if False else (c[0], c[1]))
        return merged


class BamReader:
    def __init__(self, path: str, index_path: str = "", reference_path: str = ""):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"Not a BAM file: {path}")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        self.contigs: List[Tuple[str, int]] = []
        self.contig_map = {}
        for i in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            self.contigs.append((name, l_ref))
            self.contig_map[name] = i
        self._data_start = self._bgzf.tell_virtual()
        self._index = BaiIndex(index_path or path + ".bai")

    def _raw_records_in_chunks(self, chunks) -> Iterator[bytes]:
        for cbeg, cend in chunks:
            self._bgzf.seek_virtual(cbeg)
            while self._bgzf.tell_virtual() < cend:
                raw = self._bgzf.read(4)
                if len(raw) < 4:
                    break
                block_size = struct.unpack("<i", raw)[0]
                data = self._bgzf.read(block_size)
                if len(data) < block_size:
                    break
                yield data

    def _records_in_chunks(self, chunks) -> Iterator[BamRecord]:
        for data in self._raw_records_in_chunks(chunks):
            yield _decode_record(data)

    def fetch(self, tid: int, beg: int, end: int,
              primary_only: bool = True) -> Iterator[BamRecord]:
        """Yield records overlapping [beg, end) on contig `tid` (0-based).

        Region/flag filters run on the cheap fixed-size record prefix;
        bases/quals/name only decode for records that pass (the BAI linear
        index is 16kb-grained, so chunks often start well before `beg`).
        When the native runtime library is available, the record walk +
        prefix filter run in C (native/bam_scan.cpp) and Python decodes
        survivors only."""
        lib = _native_scan_lib()
        if lib is not None:
            yield from self._fetch_native(lib, tid, beg, end, primary_only)
            return
        for data in self._raw_records_in_chunks(
                self._index.chunks_for_region(tid, beg, end)):
            refid, pos = struct.unpack_from("<ii", data, 0)
            if refid != tid:
                continue
            if pos >= end:
                break
            flag = struct.unpack_from("<H", data, 14)[0]
            if primary_only and (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)):
                continue
            if pos + 1 <= beg:
                # needs the CIGAR reference span to decide overlap
                l_read_name = data[8]
                n_cigar = struct.unpack_from("<H", data, 12)[0]
                off = 32 + l_read_name
                rlen = 0
                for v in struct.unpack_from(f"<{n_cigar}I", data, off):
                    if (v & 0xF) in _REF_CONSUME:
                        rlen += v >> 4
                if pos + (rlen if rlen > 0 else 1) <= beg:
                    continue
            yield _decode_record(data)

    def _fetch_native(self, lib, tid: int, beg: int, end: int,
                      primary_only: bool) -> Iterator[BamRecord]:
        """fetch() with the record walk + prefix filter in C: per merged
        BAI chunk, BGZF blocks decompress into one growing buffer and
        native/bam_scan.cpp returns the offsets of passing records."""
        import ctypes

        exclude = (FLAG_SECONDARY | FLAG_SUPPLEMENTARY) if primary_only \
            else 0
        cap = 8192
        out_off = (ctypes.c_int64 * cap)()
        consumed = ctypes.c_int64()
        state = ctypes.c_int()
        bgzf = self._bgzf
        for cbeg, cend in self._index.chunks_for_region(tid, beg, end):
            buf = bytearray()
            coffset = cbeg >> 16
            start = cbeg & 0xFFFF
            cend_coffset, cend_uoffset = cend >> 16, cend & 0xFFFF
            # records stop STARTING at the chunk-end virtual offset, but
            # the last one may still span into later blocks
            stop_off = -1
            eof = False
            while True:
                if not eof:
                    base = len(buf)
                    data, coffset_next = bgzf.block_at(coffset)
                    if data:
                        buf += data
                        if coffset == cend_coffset:
                            stop_off = base + cend_uoffset
                        coffset = coffset_next
                    else:
                        eof = True
                while True:
                    cbuf = (ctypes.c_char * len(buf)).from_buffer(buf) \
                        if buf else (ctypes.c_char * 1)()
                    n = lib.bam_scan(
                        cbuf, len(buf), start, stop_off, tid, beg, end,
                        exclude, out_off, cap, ctypes.byref(consumed),
                        ctypes.byref(state))
                    del cbuf  # release the export before growing buf
                    for k in range(n):
                        off = out_off[k]
                        bsz = struct.unpack_from("<i", buf, off)[0]
                        yield _decode_record(
                            bytes(buf[off + 4:off + 4 + bsz]))
                    start = consumed.value
                    if state.value != 2:  # 2 = capacity: rescan in place
                        break
                if state.value == 1 or eof:
                    break  # done, or no more bytes for a spanning record
                # state == 0: mid-record, append the next block

    def fetch_columns(self, tid: int, beg: int, end: int,
                      primary_only: bool = True):
        """Columnar fetch: the record walk, prefix filter AND field
        decode all run in C (bam_scan + bam_decode_batch); Python gets
        numpy arrays + one text blob. Returns None when the native
        runtime library is unavailable (callers fall back to fetch()).

        Result dict: ints [n, 8] int32 (refid, pos, mapq, flag,
        mate_refid, mate_pos, tlen, l_seq), text (bytes), offs [n, 3]
        int64 end-offsets of name/bases/quals per record within text.
        Records appear in fetch() order; CIGARs are not decoded (the
        extraction hot path never needs them — reference Read model,
        BamReader.cpp:84-107 decodeHtsAlign keeps no linear CIGAR)."""
        lib = _native_scan_lib()
        if lib is None:
            return None
        import ctypes

        import numpy as np

        exclude = (FLAG_SECONDARY | FLAG_SUPPLEMENTARY) if primary_only \
            else 0
        cap = 8192
        out_off = (ctypes.c_int64 * cap)()
        consumed = ctypes.c_int64()
        state = ctypes.c_int()
        bgzf = self._bgzf
        ints_parts = []
        text_parts = []
        offs_parts = []
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)

        def decode_batch(buf, offsets_arr, n):
            ints = np.empty((n, 8), np.int32)
            offs = np.empty((n, 3), np.int64)
            # decoded text per record = (name-1) + 2*l_seq; each record's
            # block carries ceil(l_seq/2) packed bases + l_seq quals, so
            # 2*block_size safely bounds the decoded size
            tcap = 16
            for k in range(n):
                off = offsets_arr[k]
                tcap += 2 * struct.unpack_from("<i", buf, off)[0]
            text = ctypes.create_string_buffer(max(1, tcap))
            cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
            w = lib.bam_decode_batch(
                cbuf, offsets_arr, n,
                ints.ctypes.data_as(i32p), text, tcap,
                offs.ctypes.data_as(i64p))
            del cbuf
            assert w >= 0
            ints_parts.append(ints)
            text_parts.append(text.raw[:w])
            offs_parts.append(offs)

        for cbeg, cend in self._index.chunks_for_region(tid, beg, end):
            buf = bytearray()
            coffset = cbeg >> 16
            start = cbeg & 0xFFFF
            cend_coffset, cend_uoffset = cend >> 16, cend & 0xFFFF
            stop_off = -1
            eof = False
            while True:
                if not eof:
                    base = len(buf)
                    data, coffset_next = bgzf.block_at(coffset)
                    if data:
                        buf += data
                        if coffset == cend_coffset:
                            stop_off = base + cend_uoffset
                        coffset = coffset_next
                    else:
                        eof = True
                while True:
                    cbuf = (ctypes.c_char * len(buf)).from_buffer(buf) \
                        if buf else (ctypes.c_char * 1)()
                    n = lib.bam_scan(
                        cbuf, len(buf), start, stop_off, tid, beg, end,
                        exclude, out_off, cap, ctypes.byref(consumed),
                        ctypes.byref(state))
                    del cbuf
                    if n:
                        decode_batch(buf, out_off, n)
                    start = consumed.value
                    if state.value != 2:
                        break
                if state.value == 1 or eof:
                    break

        if not ints_parts:
            return {"ints": np.empty((0, 8), np.int32), "text": b"",
                    "offs": np.empty((0, 3), np.int64)}
        # rebase per-part text offsets onto the concatenated blob
        sizes = [len(t) for t in text_parts]
        bases_off = np.cumsum([0] + sizes[:-1])
        for arr, b in zip(offs_parts, bases_off):
            arr += b
        return {"ints": np.concatenate(ints_parts),
                "text": b"".join(text_parts),
                "offs": np.concatenate(offs_parts)}

    def fetch_region(self, region_str: str, primary_only: bool = True):
        from .regions import parse_region

        chrom, start, end = parse_region(region_str)
        tid = self.contig_map[chrom]
        beg0 = (start - 1) if start else 0
        end0 = end if end else self.contigs[tid][1]
        return self.fetch(tid, beg0, end0, primary_only=primary_only)

    def get_aligned_mate(self, read: BamRecord) -> Optional[BamRecord]:
        """Find the mate of `read` near its recorded mate position.

        Matches BamReader::getAlignedMate (BamReader.cpp:328-365): query one
        base at the mate coordinate (including secondary/supplementary records,
        as the htslib iterator there does not filter flags) and return the
        first record with the same name and opposite mate order.
        """
        if read.is_mate_mapped:
            tid, beg = read.mate_chrom_id, read.mate_pos
        else:
            tid, beg = read.chrom_id, read.pos
        if tid < 0:
            return None
        for rec in self.fetch(tid, beg, beg + 1, primary_only=False):
            if rec.fragment_id == read.fragment_id and rec.is_first_mate != read.is_first_mate:
                return rec
        return None

    def index_read_counts(self):
        """Per-contig (mapped, unmapped) read counts from the BAI's
        37450 pseudo bins (hts_idx_get_stat semantics, used by idxdepth
        for per-contig 'reads'/'index_depth'); None entries when the
        index lacks stats."""
        return list(self._index.stats)

    def unplaced_read_count(self):
        """hts_idx_get_n_no_coor equivalent."""
        return self._index.n_no_coor

    def close(self):
        self._bgzf.close()
