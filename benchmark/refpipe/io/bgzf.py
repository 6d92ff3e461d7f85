"""BGZF (blocked gzip) reader with virtual-offset random access.

BGZF is the block-compressed gzip variant used by BAM/ BCF/ tabix. Each
block is an independent gzip member carrying a ``BC`` extra field with the
compressed block size; virtual file offsets are ``coffset << 16 | uoffset``.
This replaces htslib's bgzf layer used by the reference's BamReader
(the reference's src/c++/lib/common/BamReader.cpp).
"""
from __future__ import annotations

import struct
import zlib


class BgzfReader:
    #: decompressed blocks kept per reader (~64 x 64KB = 4MB): targeted
    #: extraction re-visits blocks constantly (flank-extended regions of
    #: neighbouring events share blocks, and mate recovery seeks back),
    #: and zlib.decompress was a visible slice of worker extraction time
    CACHE_BLOCKS = 64

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block_coffset = -1  # compressed offset of currently loaded block
        self._block_data = b""
        self._next_coffset = 0  # compressed offset of the block after current
        self._uoffset = 0  # position within current block
        from collections import OrderedDict

        self._cache = OrderedDict()  # coffset -> (data, next_coffset)

    def _load_block(self, coffset: int) -> None:
        if coffset == self._block_coffset:
            return
        cached = self._cache.get(coffset)
        if cached is not None:
            self._cache.move_to_end(coffset)
            self._block_data, self._next_coffset = cached
            self._block_coffset = coffset
            return
        fh = self._fh
        fh.seek(coffset)
        header = fh.read(18)
        if len(header) < 18:
            self._block_coffset = coffset
            self._block_data = b""
            self._next_coffset = coffset
            return
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"Not a BGZF block at offset {coffset}")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18] + fh.read(xlen - 6) if xlen > 6 else header[12:12 + xlen]
        # find BC subfield
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2:i + 4])[0]
            if si1 == 66 and si2 == 67:  # 'B','C'
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        cdata_len = bsize - xlen - 19 - 1
        fh.seek(coffset + 12 + xlen)
        cdata = fh.read(cdata_len)
        data = zlib.decompress(cdata, wbits=-15)
        self._block_coffset = coffset
        self._block_data = data
        self._next_coffset = coffset + bsize
        self._cache[coffset] = (data, self._next_coffset)
        if len(self._cache) > self.CACHE_BLOCKS:
            self._cache.popitem(last=False)

    def block_at(self, coffset: int):
        """Decompressed payload of the block at compressed offset
        `coffset` plus the next block's offset — the bulk-read primitive
        of the native BAM scan path (io/bam.py _fetch_native). Returns
        (b\"\", coffset) at EOF."""
        self._load_block(coffset)
        return self._block_data, self._next_coffset

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        self._load_block(coffset)
        self._uoffset = uoffset

    def tell_virtual(self) -> int:
        return (self._block_coffset << 16) | self._uoffset

    def read(self, n: int) -> bytes:
        out = []
        remaining = n
        while remaining > 0:
            if self._block_coffset < 0:
                self._load_block(0)
            avail = len(self._block_data) - self._uoffset
            if avail <= 0:
                nxt = self._next_coffset
                self._load_block(nxt)
                self._uoffset = 0
                if not self._block_data:  # EOF
                    break
                continue
            take = min(avail, remaining)
            out.append(self._block_data[self._uoffset:self._uoffset + take])
            self._uoffset += take
            remaining -= take
        return b"".join(out)

    def close(self):
        self._fh.close()


def bgzf_compress_block(data: bytes, level: int = 6) -> bytes:
    """Compress one BGZF block (<= 65280 bytes of payload)."""
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = compressor.compress(data) + compressor.flush()
    crc = zlib.crc32(data) & 0xFFFFFFFF
    bsize = len(cdata) + 19 + 6 + 1
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    return header + cdata + struct.pack("<II", crc, len(data) & 0xFFFFFFFF)


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """Minimal BGZF writer (for .vcf.gz / .json.gz outputs)."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= 65280:
            chunk = bytes(self._buf[:65280])
            del self._buf[:65280]
            self._fh.write(bgzf_compress_block(chunk))

    def close(self) -> None:
        if self._buf:
            self._fh.write(bgzf_compress_block(bytes(self._buf)))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()
