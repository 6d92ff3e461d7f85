"""FAI-indexed FASTA access.

Pure-python equivalent of the reference's ``common::FastaFile``
(the reference's src/c++/lib/common/Fasta.cpp): random access region queries
over a ``.fai``-indexed FASTA file. Queries use ``chrom:start-end`` with
1-based inclusive coordinates (htslib ``faidx_fetch_seq`` semantics).
"""
from __future__ import annotations

import os
from .regions import parse_region


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            self._build_index(path, fai)
        self._index = {}
        self._order = []
        with open(fai) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 5:
                    continue
                name, length, offset, linebases, linewidth = fields[:5]
                self._index[name] = (
                    int(length),
                    int(offset),
                    int(linebases),
                    int(linewidth),
                )
                self._order.append(name)
        self._fh = open(path, "rb")

    @staticmethod
    def _build_index(path: str, fai_path: str) -> None:
        """Create a .fai for an un-indexed FASTA (uniform line lengths)."""
        entries = []
        with open(path, "rb") as f:
            name = None
            seq_len = 0
            seq_offset = 0
            linebases = None
            linewidth = None
            offset = 0
            for raw in f:
                llen = len(raw)
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        entries.append((name, seq_len, seq_offset, linebases or 0, linewidth or 0))
                    name = line[1:].split()[0].decode()
                    seq_len = 0
                    seq_offset = offset + llen
                    linebases = None
                    linewidth = None
                else:
                    if linebases is None and line:
                        linebases = len(line)
                        linewidth = llen
                    seq_len += len(line)
                offset += llen
            if name is not None:
                entries.append((name, seq_len, seq_offset, linebases or 0, linewidth or 0))
        with open(fai_path, "w") as out:
            for e in entries:
                out.write("\t".join(str(x) for x in e) + "\n")

    @property
    def contigs(self):
        return list(self._order)

    def contig_length(self, chrom: str) -> int:
        return self._index[chrom][0]

    def fetch(self, chrom: str, start0: int, end0: int) -> str:
        """Fetch [start0, end0) using 0-based half-open coordinates."""
        length, offset, linebases, linewidth = self._index[chrom]
        start0 = max(0, start0)
        end0 = min(length, end0)
        if end0 <= start0:
            return ""
        start_line, start_rem = divmod(start0, linebases)
        file_start = offset + start_line * linewidth + start_rem
        end_line, end_rem = divmod(end0, linebases)
        file_end = offset + end_line * linewidth + end_rem
        self._fh.seek(file_start)
        raw = self._fh.read(file_end - file_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def query(self, region: str) -> str:
        """Fetch a ``chrom:start-end`` region (1-based inclusive), uppercased.

        Matches FastaFile::query (Fasta.cpp) which is used to materialise
        reference node sequences (GraphInput.cpp:100).
        """
        chrom, start, end = parse_region(region)
        if start is None:
            start = 1
        if end is None:
            end = self._index[chrom][0]
        return self.fetch(chrom, start - 1, end).upper()

    def close(self):
        self._fh.close()
