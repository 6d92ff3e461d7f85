"""Fast depth and read-length estimation from a BAM.

Equivalent of the reference's ``idxdepth`` tool
(src/c++/lib/idxdepth/DepthEstimation.cpp +
BamReader::estimateDepth, BamReader.cpp:366-590): per-contig sampled
pileup depth (median/variance with convergence checks), autosome/sex
chromosome classification by regex, and a summary JSON consumed by the
sample manifest.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..io.cram import open_alignment_reader as BamReader
from ..io.fasta import FastaFile
from ..utils.statistics import P2Quantile, mean, variance_population

_INTERVAL_LENGTH = 2_000_000
_DP_ACCURACY = 0.05

DEFAULT_AUTOSOME_REGEX = r"(chr)?[1-9][0-9]?"
DEFAULT_SEX_CHROMOSOME_REGEX = r"(chr)?[XY]"


class _Pileup:
    """Sorted pileup for depth sampling (common::ReadPileup,
    ReadPileup.cpp): reads must arrive position-sorted; pileup(pos)
    visits reads overlapping pos; flush(pos) discards reads ending
    before pos."""

    def __init__(self):
        self.reads: List[tuple] = []  # (pos, end)  end exclusive

    def add_read(self, pos: int, length: int = 150):
        if self.reads and pos < self.reads[-1][0]:
            raise RuntimeError(
                "reads must be added in sorted order")
        self.reads.append((pos, pos + length))

    def pileup(self, pos: int) -> List[int]:
        """Positions of reads overlapping `pos` (ReadPileup::pileup)."""
        return [s for s, e in self.reads if s <= pos < e]

    def flush(self, pos: int) -> None:
        """Remove reads with end < pos (ReadPileup::flush)."""
        self.reads = [(s, e) for s, e in self.reads if e >= pos]

    def depth_at(self, pos: int) -> int:
        return len(self.pileup(pos))


def _sample_depths(starts: List[int], lengths: List[int], first_pos: int,
                   last_pos: int, step: int) -> List[float]:
    """Pileup depth at positions first_pos, first_pos+step, … ≤ last_pos,
    in O((reads + samples)·log reads) via two sorted rank lookups:
    depth(p) = #(start ≤ p) − #(end ≤ p). Replaces the per-position
    rescans of the read list (quadratic on a real 30x WGS contig)."""
    import numpy as np

    s = np.asarray(starts, dtype=np.int64)
    e = np.sort(s + np.asarray(lengths, dtype=np.int64))
    pos = np.arange(first_pos, last_pos + 1, step, dtype=np.int64)
    depth = (np.searchsorted(s, pos, side="right")
             - np.searchsorted(e, pos, side="right"))
    return depth.astype(np.float64).tolist()


def estimate_contig_depth(reader: BamReader, tid: int,
                          contig_len: int, robust: bool = False) -> dict:
    """BamReader::estimateDepth (BamReader.cpp:366-590): subdivide the
    contig into up to 20 intervals, sample reads (10kb / 40k read chunks),
    accumulate stepped pileup depths until the median converges.

    The reference accumulates the depth median/variance with boost
    streaming accumulators (BamReader.cpp:443-444 `tag::median` — a P²
    estimator — and `tag::variance`); ``P2Quantile`` is the parity port of
    that. The reference also ships a MinCovDet robust Gaussian
    (statistics/MinCovDetGaussian.cpp) which no production caller wires
    in; ``robust=True`` fits it over the sampled depths
    (utils/statistics.py parity implementation) as an optional
    outlier-resistant alternative for contigs with coverage spikes.
    """
    intervals = [(0, contig_len - 1)]
    max_size = contig_len
    while max_size > _INTERVAL_LENGTH and len(intervals) < 20:
        new_intervals = []
        max_size = 0
        for s, e in intervals:
            length = e - s + 1
            if length > _INTERVAL_LENGTH:
                new_intervals.append((s, s + length // 2))
                if length > 1:
                    new_intervals.append((s + length // 2 + 1, e))
                max_size = max(max_size, (length + 1) // 2)
            else:
                new_intervals.append((s, e))
                max_size = max(max_size, length)
        intervals = new_intervals

    empty = [False] * len(intervals)
    read_lengths: List[float] = []
    rl_median = P2Quantile()
    depth_median = P2Quantile()
    depth_values: List[float] = []

    converged = False
    prev_depth = float("inf")
    cycle = 0
    intervals = [list(iv) for iv in intervals]
    while not converged and not all(empty) and cycle < 10:
        for ptr, iv in enumerate(intervals):
            if empty[ptr]:
                continue
            start, end = iv
            starts: List[int] = []
            lengths: List[int] = []
            any_reads = 0
            last_pos = start
            exhausted = True
            for rec in reader.fetch(tid, start, end + 1,
                                    primary_only=True):
                # NB the reference's qual check is on the quality-string
                # pointer (BamReader.cpp:520), not MAPQ — effectively only
                # position-filtering applies here
                if not rec.quals or rec.pos + len(rec.bases) < start:
                    continue
                any_reads += 1
                read_lengths.append(float(len(rec.bases)))
                rl_median.add(float(len(rec.bases)))
                starts.append(rec.pos)
                lengths.append(len(rec.bases))
                last_pos = rec.pos
                if last_pos - start > 10_000 and any_reads > 40_000:
                    exhausted = False
                    break
            cur_rl = int(rl_median.value()) or 1
            for d in _sample_depths(starts, lengths, start, last_pos,
                                    max(1, cur_rl // 2)):
                depth_median.add(d)
                depth_values.append(d)
            if exhausted:
                empty[ptr] = True
            else:
                iv[0] = last_pos
                iv[1] = max(last_pos, iv[1])
            if any_reads > 10_000 and cycle > 0:
                cur = depth_median.value()
                if abs(cur - prev_depth) < _DP_ACCURACY:
                    converged = True
                    break
                prev_depth = cur
        cycle += 1
        cur = depth_median.value()
        if cycle > 1 and abs(cur - prev_depth) < _DP_ACCURACY:
            converged = True
        prev_depth = cur

    rl_var = variance_population(read_lengths) if read_lengths else 0.0
    out = {
        "depth_median": round(depth_median.value() * 100) / 100,
        "depth_variance": round(
            variance_population(depth_values) * 100) / 100
        if depth_values else 0.0,
        "read_length": int(rl_median.value()),
        "read_length_unique": abs(rl_var) < 2.2e-16,
        "read_count": len(read_lengths),
    }
    if robust and depth_values:
        from ..utils.statistics import MinCovDetGaussian

        mcd = MinCovDetGaussian()
        mcd.fit(depth_values)
        # zero raw variance degenerates the chi² reweighting to NaN
        # (division by a zero z-score scale) — the raw fit is exact then
        m, v = mcd.mean, mcd.variance
        if m != m or v != v:  # NaN
            m, v = mcd.raw_mean, mcd.raw_variance
        out["depth_robust_mean"] = round(m * 100) / 100
        out["depth_robust_variance"] = round(v * 100) / 100
    return out


def estimate_depths(bam_path: str, reference_path: str,
                    bam_index_path: str = "",
                    include_regex: str = "",
                    autosome_regex: str = DEFAULT_AUTOSOME_REGEX,
                    sex_chromosome_regex: str = DEFAULT_SEX_CHROMOSOME_REGEX,
                    include_alt_contig: bool = False,
                    threads: int = 1, robust: bool = False) -> dict:
    """estimateDepths (DepthEstimation.cpp:48-295)."""
    reference = FastaFile(reference_path)
    reader = BamReader(bam_path, bam_index_path, reference_path)
    ref_contigs = set(reference.contigs)

    inc_re = re.compile(include_regex) if include_regex else None
    auto_re = re.compile(autosome_regex)
    sex_re = re.compile(sex_chromosome_regex)

    output: dict = {
        "reference": reference_path,
        "bam_path": bam_path,
        "contigs": [],
    }

    bam_chromosomes = set()
    autosome = []
    sex_chromosomes = []
    for name, length in reader.contigs:
        if not include_alt_contig and len(name) > 5:
            continue
        if inc_re is None or inc_re.fullmatch(name):
            bam_chromosomes.add(name)
        if name not in ref_contigs:
            raise ValueError(
                f"BAM does not match reference: {name} missing from "
                f"{reference_path}")
        if length != reference.contig_length(name):
            raise ValueError(f"Contig lengths differ for {name}")
        if auto_re.fullmatch(name):
            autosome.append(name)
        if sex_re.fullmatch(name):
            sex_chromosomes.append(name)

    # per-contig index read counts (DepthEstimation.cpp:122-147)
    index_stats = reader.index_read_counts()
    unaligned = 0
    for st in index_stats or []:
        if st is not None:
            unaligned += st[1]
    if reader.unplaced_read_count():
        unaligned += reader.unplaced_read_count()
    output["unaligned_reads"] = unaligned

    read_length = 0
    has_rl = False
    rl_unique = True
    per_contig_depth: Dict[str, dict] = {}
    for tid, (name, length) in enumerate(reader.contigs):
        if name not in bam_chromosomes:
            continue
        info = estimate_contig_depth(reader, tid, length, robust=robust)
        contig_info = {
            "name": name,
            "length": length,
            "non_n_length": length,
            "depth": info["depth_median"],
            "depth_variance": info["depth_variance"],
            "reads_for_estimation": info["read_count"],
        }
        if robust:
            contig_info["depth_robust_mean"] = info.get(
                "depth_robust_mean", 0.0)
            contig_info["depth_robust_variance"] = info.get(
                "depth_robust_variance", 0.0)
        if index_stats and index_stats[tid] and index_stats[tid][0] > 0:
            contig_info["reads"] = index_stats[tid][0]
            contig_info["index_depth"] = (
                info["read_length"] * index_stats[tid][0] // length)
        output["contigs"].append(contig_info)
        if (has_rl and read_length != info["read_length"]) or (
                not info["read_length_unique"]):
            rl_unique = False
        read_length = max(read_length, info["read_length"])
        has_rl = True
        per_contig_depth[name] = info

    if has_rl:
        output["read_length"] = read_length
    if not rl_unique:
        output["read_length_unique"] = False

    if autosome:
        sc_depth = 0.0
        sc_length = 0
        contigs = []
        for name in sorted(autosome):
            if name not in bam_chromosomes or name not in per_contig_depth:
                continue
            size = reference.contig_length(name)
            sc_depth += size * per_contig_depth[name]["depth_median"]
            sc_length += size
            contigs.append(name)
        if sc_length:
            output["autosome"] = {
                "contigs": contigs,
                "depth": sc_depth / sc_length,
            }
    if sex_chromosomes:
        output["sex_chromosomes"] = {
            "contigs": [c for c in sorted(sex_chromosomes)
                        if c in bam_chromosomes],
        }
    return output
