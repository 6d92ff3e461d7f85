"""Targeted read extraction from BAM with mate recovery.

Equivalent of the reference's ``common::extractReads``
(the reference's src/c++/lib/common/ReadExtraction.cpp): per target region,
iterate primary alignments from the region extended by 3× the average
fragment length, keep reads (or their mates) overlapping the target, and —
unless the read cap was hit or reads are long relative to the largest
insertion — recover distant mates (>1kb away) by point queries.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..io.bam import BamReader, BamRecord
from ..io.regions import Region
from .read import Read

DEFAULT_AVG_FRAGMENT_LENGTH = 333  # ReadExtraction.hh:43
MAX_NORMAL_MATE_DISTANCE = 1000  # ReadExtraction.cpp:204


class ReadPairs:
    """fragment-id keyed read pairs (common::ReadPairs; std::map ordering)."""

    def __init__(self):
        self._pairs: Dict[str, List[Optional[Read]]] = {}
        self.num_reads = 0

    def add(self, read: Read):
        # ReadPair::add overwrites the slot (last record wins); num_reads
        # counts newly filled slots (ReadPairs.cpp:31-41)
        mates = self._pairs.setdefault(read.fragment_id, [None, None])
        slot = 0 if read.is_first_mate else 1
        if mates[slot] is None:
            self.num_reads += 1
        mates[slot] = read

    def __iter__(self):
        return iter(sorted(self._pairs.items()))

    def get_reads(self) -> List[Read]:
        out = []
        for _, mates in sorted(self._pairs.items()):
            for r in mates:
                if r is not None:
                    out.append(r)
        return out


def is_read_or_mate_in_region(read: Read, region: Region) -> bool:
    """ReadExtraction.cpp:160-181 (1 base overlap; positions 0-based)."""
    if (read.pos > region.end
            or read.pos + len(read.bases) < region.start):
        if read.chrom_id == read.mate_chrom_id:
            if not (read.mate_pos > region.end
                    or read.mate_pos + len(read.bases) < region.start):
                return True
        return False
    return True


def _columns_to_pairs(cols, region: Region, read_pairs: "ReadPairs"):
    """Vectorized region filter + Read construction from a columnar
    fetch (io/bam.py fetch_columns): the is_read_or_mate_in_region
    predicate evaluates over numpy arrays and only surviving records
    become Python objects. Returns (total_read_length, n_with_bases)."""
    import numpy as np

    ints = cols["ints"]
    if not len(ints):
        return 0, 0
    chrom = ints[:, 0]
    pos = ints[:, 1]
    mchrom = ints[:, 4]
    mpos = ints[:, 5]
    l_seq = ints[:, 7]
    in_self = ~((pos > region.end) | (pos + l_seq < region.start))
    in_mate = ((chrom == mchrom)
               & ~((mpos > region.end) | (mpos + l_seq < region.start)))
    keep = np.nonzero(in_self | in_mate)[0]

    text = cols["text"]
    offs = cols["offs"]
    # bulk-convert the surviving rows once (ndarray scalar indexing per
    # field was a visible share of worker extraction time)
    kept_ints = ints[keep].tolist()
    kept_offs = offs[keep].tolist()
    name_starts = np.where(keep > 0, offs[keep - 1, 2], 0).tolist()
    for f, (name_end, bases_end, quals_end), name_start in zip(
            kept_ints, kept_offs, name_starts):
        flag = f[3]
        read_pairs.add(Read(
            fragment_id=text[name_start:name_end].decode(),
            bases=text[name_end:bases_end].decode(),
            quals=text[bases_end:quals_end].decode(),
            is_mapped=(flag & 0x4) == 0,
            is_first_mate=(flag & 0x40) != 0,
            is_mate_mapped=(flag & 0x8) == 0,
            is_reverse_strand=(flag & 0x10) != 0,
            is_mate_reverse_strand=(flag & 0x20) != 0,
            chrom_id=f[0],
            pos=f[1],
            mapq=f[2],
            mate_chrom_id=f[4],
            mate_pos=f[5],
        ))
    return int(l_seq.sum()), int((l_seq > 0).sum())


def extract_reads_from_region(
        all_reads: List[Read], max_num_reads: int, reader: BamReader,
        region: Region, longest_alt_insertion: int,
        avr_fragment_length: int = DEFAULT_AVG_FRAGMENT_LENGTH
) -> Tuple[int, int]:
    extended = region.extended(avr_fragment_length * 3)
    tid = reader.contig_map.get(region.chrom)
    if tid is None:
        return (0, 0)

    read_pairs = ReadPairs()
    total_read_length = 0
    n_with_bases = 0
    # NB the reference's Region carries 1-based coordinates into
    # sam_itr_querys; record positions below are 0-based as decoded
    cols = None
    fetch_columns = getattr(reader, "fetch_columns", None)
    if fetch_columns is not None:
        cols = fetch_columns(tid, max(0, extended.start - 1), extended.end)
    if cols is not None and len(cols["ints"]) < max_num_reads:
        # fast columnar path (C-side decode); the record count bounds
        # num_reads so the cap cannot trip mid-stream
        total_read_length, n_with_bases = _columns_to_pairs(
            cols, region, read_pairs)
    else:
        for rec in reader.fetch(tid, max(0, extended.start - 1),
                                extended.end):
            if read_pairs.num_reads == max_num_reads:
                break
            if rec.bases:
                total_read_length += len(rec.bases)
                n_with_bases += 1
            read = Read.from_bam_record(rec)
            if is_read_or_mate_in_region(read, region):
                read_pairs.add(read)
    read_length = total_read_length // n_with_bases if n_with_bases else 0

    if (read_pairs.num_reads == max_num_reads
            or read_length > longest_alt_insertion * 2):
        result = (read_pairs.num_reads, 0)
    else:
        n_original = read_pairs.num_reads
        recover_missing_mates(reader, read_pairs)
        result = (n_original, read_pairs.num_reads - n_original)

    all_reads.extend(read_pairs.get_reads())
    return result


def recover_missing_mates(reader: BamReader, read_pairs: ReadPairs):
    """ReadExtraction.cpp:189-219."""
    for _, mates in list(read_pairs):
        first, second = mates
        if first is not None and second is not None:
            continue
        init = first if first is not None else second
        if init is None:
            continue
        if (init.chrom_id == init.mate_chrom_id
                and abs(init.pos - init.mate_pos) < MAX_NORMAL_MATE_DISTANCE):
            continue
        probe = BamRecord(
            fragment_id=init.fragment_id,
            flag=(0x40 if init.is_first_mate else 0x80)
            | (0 if init.is_mate_mapped else 0x8),
            chrom_id=init.chrom_id,
            pos=init.pos,
            mapq=0,
            cigar=[],
            mate_chrom_id=init.mate_chrom_id,
            mate_pos=init.mate_pos,
            tlen=0,
            bases="",
            quals="",
        )
        found = reader.get_aligned_mate(probe)
        if found is not None:
            read_pairs.add(Read.from_bam_record(found))


def extract_reads(reader: BamReader, target_regions, max_num_reads: int,
                  longest_alt_insertion: int,
                  avr_fragment_length: int = DEFAULT_AVG_FRAGMENT_LENGTH
                  ) -> List[Read]:
    """extractReads (ReadExtraction.cpp:38-58)."""
    all_reads: List[Read] = []
    for region in target_regions:
        if isinstance(region, str):
            region = Region.from_string(region)
        extract_reads_from_region(
            all_reads, max_num_reads, reader, region, longest_alt_insertion,
            avr_fragment_length)
    return all_reads
