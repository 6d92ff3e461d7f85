"""Shared fixtures of the benchmark's CPU tests: the fixture cells (tiny
configurations and mixes under ``fixture/``) and an independent BAM/BAI
reader."""
from __future__ import annotations

import os
import struct
import zlib

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixture")
BENCH_JSON = os.path.join(FIXTURE, "BENCHMARK.json")
SEED = 2 ** 31 + 7


def fixture_cell(name: str):
    from benchmark.cells import load_cell

    return load_cell(name, BENCH_JSON, base=FIXTURE)


def bgzf_blocks(path: str):
    """{compressed offset: decompressed bytes} of every BGZF block."""
    blocks = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        assert data[off:off + 4] == b"\x1f\x8b\x08\x04"
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        raw = data[off + 12 + xlen:off + bsize - 8]
        blocks[off] = zlib.decompress(raw, -15)
        off += bsize
    return blocks


def read_bai(path: str):
    """(bins {bin: [(beg, end)]}, linear offsets) of a one-reference BAI."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"BAI\x01"
    n_ref, n_bin = struct.unpack_from("<ii", data, 4)
    assert n_ref == 1
    off = 12
    bins = {}
    for _ in range(n_bin):
        b, n_chunk = struct.unpack_from("<Ii", data, off)
        off += 8
        bins[b] = [struct.unpack_from("<QQ", data, off + 16 * k)
                   for k in range(n_chunk)]
        off += 16 * n_chunk
    n_intv = struct.unpack_from("<i", data, off)[0]
    lin = list(struct.unpack_from(f"<{n_intv}Q", data, off + 4))
    return bins, lin


def records_at(blocks, voff: int, vend: int):
    """(pos, voff) of the records from virtual offset voff up to vend."""
    coffs = sorted(blocks)
    out = []
    c, u = voff >> 16, voff & 0xFFFF
    while (c << 16 | u) < vend:
        buf = blocks[c]
        if u >= len(buf):
            c = coffs[coffs.index(c) + 1]
            u = 0
            continue
        size = struct.unpack_from("<i", buf, u)[0]
        pos = struct.unpack_from("<i", buf, u + 8)[0]
        out.append((pos, c << 16 | u))
        u += 4 + size
    return out
