"""BCF 2.2 (binary VCF) reading and writing — htslib-free.

The reference handles binary BCF through htslib wrappers
(the reference's src/c++/lib/common/BCFHelpers.cpp: GT/AD/DP extraction,
sample handling) and pysam; this module gives the TPU framework the same
capability over the existing BGZF layer (io/bgzf.py). ``BcfReader``
produces exactly the header lines + per-record raw-string fields that
``io/vcf.py``'s text parser produces, so every pipeline stage
(vcf2paragraph conversion, vcfupdate) runs unchanged from ``.bcf``
input; ``BcfWriter`` encodes the same record model back to spec-valid
BCF (typed descriptors, header string/contig dictionaries, GT packing).

Format reference: VCFv4.2 specification §6 (BCF2.2 site/sample encoding).
"""
from __future__ import annotations

import gzip
import re
import struct
from typing import Dict, List, Optional, Tuple

from .bgzf import BgzfWriter

# typed-descriptor type codes (spec table: "Type encoding")
_T_MISSING = 0
_T_INT8 = 1
_T_INT16 = 2
_T_INT32 = 3
_T_FLOAT = 5
_T_CHAR = 7

_INT_MISSING = {_T_INT8: -128, _T_INT16: -32768, _T_INT32: -2147483648}
_INT_EOV = {_T_INT8: -127, _T_INT16: -32767, _T_INT32: -2147483647}
# usable ranges exclude the reserved low sentinels
_INT_BOUNDS = {_T_INT8: (-120, 127), _T_INT16: (-32760, 32767),
               _T_INT32: (-2147483640, 2147483647)}
_INT_FMT = {_T_INT8: "b", _T_INT16: "h", _T_INT32: "i"}
_FLOAT_MISSING_BITS = 0x7F800001
_FLOAT_EOV_BITS = 0x7F800002


def _parse_structured_header(line: str) -> Dict[str, str]:
    """``##INFO=<ID=DP,Number=1,Type=Integer,...>`` → field dict."""
    body = line.split("=<", 1)[1].rstrip(">")
    out = {}
    for m in re.finditer(r'(\w+)=("(?:[^"\\]|\\.)*"|[^,]*)', body):
        k, v = m.group(1), m.group(2)
        if v.startswith('"') and v.endswith('"'):
            v = v[1:-1]
        out[k] = v
    return out


class _HeaderDicts:
    """The two BCF dictionaries: strings (FILTER/INFO/FORMAT IDs, PASS
    implicitly first) and contigs (##contig IDs), honoring explicit
    IDX= keys on read."""

    def __init__(self, header_lines: List[str]):
        self.str2idx: Dict[str, int] = {}
        self.idx2str: Dict[int, str] = {}
        self.contig2idx: Dict[str, int] = {}
        self.idx2contig: Dict[int, str] = {}
        # ID -> (Number, Type) for INFO / FORMAT typing
        self.info_types: Dict[str, Tuple[str, str]] = {}
        self.format_types: Dict[str, Tuple[str, str]] = {}
        self._add_string("PASS", None)
        for line in header_lines:
            if line.startswith(("##FILTER=<", "##INFO=<", "##FORMAT=<")):
                f = _parse_structured_header(line)
                idx = int(f["IDX"]) if "IDX" in f else None
                self._add_string(f["ID"], idx)
                if line.startswith("##INFO=<"):
                    self.info_types[f["ID"]] = (f.get("Number", "."),
                                                f.get("Type", "String"))
                elif line.startswith("##FORMAT=<"):
                    self.format_types[f["ID"]] = (f.get("Number", "."),
                                                  f.get("Type", "String"))
            elif line.startswith("##contig=<"):
                f = _parse_structured_header(line)
                idx = int(f["IDX"]) if "IDX" in f \
                    else len(self.contig2idx)
                self.contig2idx[f["ID"]] = idx
                self.idx2contig[idx] = f["ID"]

    def _add_string(self, sid: str, idx: Optional[int]) -> None:
        if sid in self.str2idx and idx is None:
            return
        if idx is None:
            idx = len(self.str2idx)
            while idx in self.idx2str:
                idx += 1
        self.str2idx[sid] = idx
        self.idx2str[idx] = sid


# ---------------------------------------------------------------- decoding


class _RecordBuf:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b


def _read_typed_descriptor(buf: _RecordBuf) -> Tuple[int, int]:
    b = buf.take(1)[0]
    t, n = b & 0x0F, b >> 4
    if n == 15:
        n = _read_typed_ints(buf)[0]
    return t, n


def _read_typed_ints(buf: _RecordBuf) -> List[int]:
    t, n = _read_typed_descriptor(buf)
    if t == _T_MISSING:
        return []
    fmt = "<%d%s" % (n, _INT_FMT[t])
    return list(struct.unpack(fmt, buf.take(struct.calcsize(fmt))))


def _decode_values(buf: _RecordBuf, t: int, n: int, count: int = 1):
    """count fixed-width vectors of n elements each (count>1 = FORMAT
    per-sample matrix). Returns a list of per-vector python lists; char
    vectors come back as str."""
    out = []
    if t == _T_MISSING:
        return [[] for _ in range(count)]
    if t == _T_CHAR:
        for _ in range(count):
            out.append(buf.take(n).decode("latin-1"))
        return out
    if t == _T_FLOAT:
        raw_bytes = buf.take(4 * n * count)
        raw = struct.unpack("<%df" % (n * count), raw_bytes)
        # bit patterns must come from the wire bytes: packing the
        # unpacked float quiets the missing/EOV NaN payloads
        bits = struct.unpack("<%dI" % (n * count), raw_bytes)
        for c in range(count):
            vec = []
            for i in range(n):
                b = bits[c * n + i]
                if b == _FLOAT_EOV_BITS:
                    break
                vec.append(None if b == _FLOAT_MISSING_BITS
                           else raw[c * n + i])
            out.append(vec)
        return out
    fmt = "<%d%s" % (n * count, _INT_FMT[t])
    vals = struct.unpack(fmt, buf.take(struct.calcsize(fmt)))
    miss, eov = _INT_MISSING[t], _INT_EOV[t]
    for c in range(count):
        vec = []
        for i in range(n):
            v = vals[c * n + i]
            if v == eov:
                break
            vec.append(None if v == miss else v)
        out.append(vec)
    return out


def _render_scalar(v) -> str:
    if v is None:
        return "."
    if isinstance(v, float):
        s = "%g" % v
        return s
    return str(v)


def _render_vector(vec) -> str:
    if isinstance(vec, str):
        return vec if vec else "."
    if not vec:
        return "."
    return ",".join(_render_scalar(v) for v in vec)


def _render_gt(vec) -> str:
    if isinstance(vec, str) or not vec:
        return "."
    parts = []
    for i, v in enumerate(vec):
        if v is None or v == 0:
            al = "."
        else:
            al = str((v >> 1) - 1)
        if i == 0:
            parts.append(al)
        else:
            parts.append(("|" if (v or 0) & 1 else "/") + al)
    return "".join(parts)


class BcfReader:
    """Streaming BCF 2.x reader with the same observable surface the
    text parser feeds ``VcfReader``: ``header_lines``, ``samples``, and
    an iterator of raw-field tuples."""

    def __init__(self, path: str):
        self.path = path
        self._fh = gzip.open(path, "rb")
        magic = self._fh.read(5)
        if magic[:3] != b"BCF":
            raise ValueError(f"Not a BCF file: {path}")
        (l_text,) = struct.unpack("<I", self._fh.read(4))
        text = self._fh.read(l_text).rstrip(b"\x00").decode()
        lines = text.rstrip("\n").split("\n")
        self.header_lines = [ln for ln in lines if ln.startswith("##")]
        chrom = [ln for ln in lines if ln.startswith("#CHROM")]
        self.samples = (chrom[0].split("\t")[9:]
                        if chrom and len(chrom[0].split("\t")) > 9 else [])
        self._dicts = _HeaderDicts(self.header_lines)

    def __iter__(self):
        while True:
            head = self._fh.read(8)
            if len(head) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", head)
            payload = self._fh.read(l_shared + l_indiv)
            yield self._decode_record(payload, l_shared)

    def _decode_record(self, payload: bytes, l_shared: int):
        d = self._dicts
        buf = _RecordBuf(payload)
        (contig_idx, pos0, _rlen) = struct.unpack("<iii", buf.take(12))
        (qual_bits,) = struct.unpack("<I", buf.take(4))
        (n_allele_info,) = struct.unpack("<I", buf.take(4))
        (n_fmt_sample,) = struct.unpack("<I", buf.take(4))
        n_allele, n_info = n_allele_info >> 16, n_allele_info & 0xFFFF
        n_fmt, n_sample = n_fmt_sample >> 24, n_fmt_sample & 0xFFFFFF

        vid = _decode_values(buf, *_read_typed_descriptor(buf))[0] or None
        if vid == ".":
            vid = None
        alleles = []
        for _ in range(n_allele):
            t, n = _read_typed_descriptor(buf)
            alleles.append(_decode_values(buf, t, n)[0])
        filt_idx = _read_typed_ints(buf)
        filters = [d.idx2str[i] for i in filt_idx]
        if filters == ["PASS"]:
            filters_field = "PASS"
        elif filters:
            filters_field = ";".join(filters)
        else:
            filters_field = "."

        info: Dict[str, object] = {}
        for _ in range(n_info):
            key = d.idx2str[_read_typed_ints(buf)[0]]
            t, n = _read_typed_descriptor(buf)
            if t == _T_MISSING:
                info[key] = True
                continue
            vec = _decode_values(buf, t, n)[0]
            info[key] = _render_vector(vec)

        buf.pos = l_shared
        fmt_keys: List[str] = []
        sample_values: Dict[str, Dict[str, str]] = {
            s: {} for s in self.samples[:n_sample]}
        for _ in range(n_fmt):
            key = d.idx2str[_read_typed_ints(buf)[0]]
            fmt_keys.append(key)
            t, n = _read_typed_descriptor(buf)
            vecs = _decode_values(buf, t, n, count=n_sample)
            render = _render_gt if key == "GT" else _render_vector
            for s, vec in zip(self.samples, vecs):
                sample_values[s][key] = render(vec)

        qual: Optional[str] = None
        if qual_bits not in (_FLOAT_MISSING_BITS, 0x7FC00000):
            (qf,) = struct.unpack("<f", struct.pack("<I", qual_bits))
            qual = _render_scalar(qf)

        return {
            "chrom": d.idx2contig[contig_idx],
            "pos": pos0 + 1,
            "vid": vid,
            "ref": alleles[0] if alleles else "N",
            "alts": alleles[1:],
            "qual": qual,
            "filters": ([] if filters_field == "."
                        else filters_field.split(";")),
            "info": info,
            "fmt_keys": fmt_keys,
            "sample_values": sample_values,
        }

    def close(self):
        self._fh.close()


# ---------------------------------------------------------------- encoding


def _encode_typed_descriptor(t: int, n: int) -> bytes:
    if n < 15:
        return bytes([(n << 4) | t])
    return bytes([(15 << 4) | t]) + _encode_typed_ints([n])


def _int_type_for(vals) -> int:
    lo = min((v for v in vals if v is not None), default=0)
    hi = max((v for v in vals if v is not None), default=0)
    for t in (_T_INT8, _T_INT16, _T_INT32):
        b = _INT_BOUNDS[t]
        if lo >= b[0] and hi <= b[1]:
            return t
    raise ValueError(f"BCF int out of range: {lo}..{hi}")


def _encode_typed_ints(vals: List[Optional[int]],
                       force_t: Optional[int] = None) -> bytes:
    if not vals:
        return _encode_typed_descriptor(_T_MISSING, 0)
    t = force_t if force_t is not None else _int_type_for(vals)
    enc = [(_INT_MISSING[t] if v is None else v) for v in vals]
    return (_encode_typed_descriptor(t, len(vals))
            + struct.pack("<%d%s" % (len(enc), _INT_FMT[t]), *enc))


def _encode_typed_floats(vals: List[Optional[float]]) -> bytes:
    if not vals:
        return _encode_typed_descriptor(_T_MISSING, 0)
    out = bytearray(_encode_typed_descriptor(_T_FLOAT, len(vals)))
    for v in vals:
        if v is None:
            out += struct.pack("<I", _FLOAT_MISSING_BITS)
        else:
            out += struct.pack("<f", float(v))
    return bytes(out)


def _encode_typed_string(s: str) -> bytes:
    data = s.encode("latin-1")
    return _encode_typed_descriptor(_T_CHAR, len(data)) + data


def _parse_number_list(raw: str, typ: str):
    """Raw VCF field string → typed python list (None for '.')."""
    out = []
    for tok in raw.split(","):
        if tok in (".", ""):
            out.append(None)
        elif typ == "Integer":
            out.append(int(tok))
        else:
            out.append(float(tok))
    return out


def _gt_ints(raw: str) -> List[int]:
    """``0/1`` → BCF GT ints ((allele+1)<<1 | phased-with-previous)."""
    if raw in (".", ""):
        return [0]
    out = []
    sep_phased = False
    for m in re.finditer(r"([.\d]+)([/|]?)", raw):
        al = m.group(1)
        v = 0 if al == "." else (int(al) + 1) << 1
        if sep_phased:
            v |= 1
        out.append(v)
        sep_phased = m.group(2) == "|"
    return out or [0]


class BcfWriter:
    """Mirror of ``io.vcf.VcfWriter`` that emits BCF 2.2 over BGZF."""

    def __init__(self, path: str, header_lines: List[str],
                 samples: List[str]):
        self.path = path
        self.samples = samples
        self._dicts = _HeaderDicts(header_lines)
        self._sink = BgzfWriter(path)
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                "INFO"]
        if samples:
            cols.append("FORMAT")
            cols.extend(samples)
        text = "\n".join(list(header_lines) + ["\t".join(cols)]) \
            + "\n\x00"
        data = text.encode()
        self._sink.write(b"BCF\x02\x02" + struct.pack("<I", len(data))
                         + data)

    def _info_bytes(self, key: str, value) -> bytes:
        d = self._dicts
        if key not in d.str2idx:
            raise ValueError(f"INFO key {key!r} missing from BCF header")
        out = _encode_typed_ints([d.str2idx[key]])
        number, typ = d.info_types.get(key, (".", "String"))
        if value is True or typ == "Flag":
            return out + _encode_typed_descriptor(_T_MISSING, 0)
        raw = str(value)
        if typ == "Integer":
            return out + _encode_typed_ints(_parse_number_list(raw, typ))
        if typ == "Float":
            return out + _encode_typed_floats(_parse_number_list(raw, typ))
        return out + _encode_typed_string(raw)

    def write(self, record) -> None:
        d = self._dicts
        if record.chrom not in d.contig2idx:
            raise ValueError(
                f"contig {record.chrom!r} has no ##contig header line "
                "(required for BCF output)")
        shared = bytearray()
        rlen = record.stop - record.pos + 1
        shared += struct.pack("<iii", d.contig2idx[record.chrom],
                              record.pos - 1, rlen)
        if record.qual is None:
            shared += struct.pack("<I", _FLOAT_MISSING_BITS)
        else:
            shared += struct.pack("<f", float(record.qual))
        alleles = [record.ref] + list(record.alts)
        info_items = list(record.info.items())
        shared += struct.pack("<I", (len(alleles) << 16) | len(info_items))
        shared += struct.pack(
            "<I", (len(record.fmt_keys) << 24) | len(self.samples))
        shared += _encode_typed_string(record.id or "")
        for al in alleles:
            shared += _encode_typed_string(al)
        shared += _encode_typed_ints(
            [d.str2idx[f] for f in record.filters])
        for k, v in info_items:
            shared += self._info_bytes(k, v)

        indiv = bytearray()
        for key in record.fmt_keys:
            if key not in d.str2idx:
                raise ValueError(
                    f"FORMAT key {key!r} missing from BCF header")
            indiv += _encode_typed_ints([d.str2idx[key]])
            number, typ = d.format_types.get(key, (".", "String"))
            raws = [record.sample_values.get(s, {}).get(key, ".")
                    for s in self.samples]
            if key == "GT":
                vecs = [_gt_ints(r) for r in raws]
                width = max(len(v) for v in vecs)
                t = _int_type_for([x for v in vecs for x in v])
                indiv += _encode_typed_descriptor(t, width)
                for v in vecs:
                    enc = v + [_INT_EOV[t]] * (width - len(v))
                    indiv += struct.pack(
                        "<%d%s" % (width, _INT_FMT[t]), *enc)
            elif typ in ("Integer", "Float"):
                vecs = [_parse_number_list(r, typ) if r not in (".", "")
                        else [None] for r in raws]
                width = max(len(v) for v in vecs)
                if typ == "Integer":
                    flat = [x for v in vecs for x in v if x is not None]
                    t = _int_type_for(flat) if flat else _T_INT8
                    indiv += _encode_typed_descriptor(t, width)
                    for v in vecs:
                        enc = [(_INT_MISSING[t] if x is None else x)
                               for x in v]
                        enc += [_INT_EOV[t]] * (width - len(v))
                        indiv += struct.pack(
                            "<%d%s" % (width, _INT_FMT[t]), *enc)
                else:
                    indiv += _encode_typed_descriptor(_T_FLOAT, width)
                    for v in vecs:
                        for x in v:
                            if x is None:
                                indiv += struct.pack(
                                    "<I", _FLOAT_MISSING_BITS)
                            else:
                                indiv += struct.pack("<f", float(x))
                        indiv += struct.pack(
                            "<I", _FLOAT_EOV_BITS) * (width - len(v))
            else:
                strs = [("" if r == "." else r) for r in raws]
                width = max(1, max(len(s) for s in strs))
                indiv += _encode_typed_descriptor(_T_CHAR, width)
                for s in strs:
                    data = (s or ".").encode("latin-1")
                    indiv += data + b"\x00" * (width - len(data))

        self._sink.write(struct.pack("<II", len(shared), len(indiv)))
        self._sink.write(bytes(shared))
        self._sink.write(bytes(indiv))

    def close(self):
        self._sink.close()
