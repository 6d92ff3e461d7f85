"""The per-event parameters and counting of the port's pipeline/grmpy.py
(frozen copy: ``GrmpyParameters``, ``make_event_genotyper``,
``_make_paragraph_parameters``)."""
from __future__ import annotations

from typing import List, Optional

from ..genotyping.graph_genotyper import GraphBreakpointGenotyper
from ..genotyping.sample_info import SampleInfo
from ..graph.model import SequenceGraph
from .paragraph import (ALL, DETAILED_READ_COUNTS, EDGE_READ_COUNTS,
                        HAPLOTYPES, NODE_READ_COUNTS, PATH_READ_COUNTS,
                        Parameters)


class GrmpyParameters:
    """grmpy::Parameters (grmpy/Parameters.hh)."""

    def __init__(self, threads: int = 0, max_reads: int = 10000,
                 bad_align_frac: float = 0.8,
                 path_sequence_matching: bool = False,
                 graph_sequence_matching: bool = True,
                 klib_sequence_matching: bool = False,
                 kmer_sequence_matching: bool = False,
                 bad_align_uniq_kmer_len: int = 0,
                 alignment_output_folder: str = "",
                 infer_read_haplotypes: bool = False,
                 progress: bool = False,
                 gt_engine: str = "auto"):
        self.threads = threads
        self.max_reads = max_reads
        self.bad_align_frac = bad_align_frac
        self.path_sequence_matching = path_sequence_matching
        self.graph_sequence_matching = graph_sequence_matching
        self.klib_sequence_matching = klib_sequence_matching
        self.kmer_sequence_matching = kmer_sequence_matching
        self.bad_align_uniq_kmer_len = bad_align_uniq_kmer_len
        self.alignment_output_folder = alignment_output_folder
        self.infer_read_haplotypes = infer_read_haplotypes
        self.progress = progress
        #: "host" = float64 parity engines per event;
        #: "device" = the float32 population engine: one call on the
        #: run's device genotypes every (event x sample x breakpoint) of
        #: the run (genotyping/device_engine.py)
        self.gt_engine = gt_engine


def make_event_genotyper(graph_desc: dict, reference_path: str,
                         genotyping_parameters: Optional[dict],
                         samples: List[SampleInfo],
                         graph: Optional[SequenceGraph] = None
                         ) -> GraphBreakpointGenotyper:
    """Breakpoint genotyper for one event with all sample alignments
    added (the counting half of grmpy::countAndGenotype). Callers that
    already built the event's SequenceGraph (the per-event analysis
    does, for alignment) pass it to skip a second from_json build."""
    root = graph_desc if graph_desc is not None else (
        samples[0].alignment_data)
    if graph is None:
        graph = SequenceGraph.from_json(root, reference_path)

    male_ploidy = 2
    female_ploidy = 2
    for t_region in root.get("target_regions", []):
        chrom = str(t_region).split(":")[0]
        if chrom in ("chrX", "X"):
            male_ploidy = 1
        elif chrom in ("chrY", "Y"):
            male_ploidy = 1
            female_ploidy = 1

    genotyper = GraphBreakpointGenotyper(graph, male_ploidy, female_ploidy)
    genotyper.set_parameters(genotyping_parameters)
    for sample_info in samples:
        genotyper.add_alignment(sample_info)
    return genotyper


def _make_paragraph_parameters(parameters: GrmpyParameters,
                               graph_desc: dict, reference_path: str,
                               write_alignments: bool) -> Parameters:
    if write_alignments:
        output_options = ALL
    else:
        output_options = (NODE_READ_COUNTS | EDGE_READ_COUNTS
                          | PATH_READ_COUNTS | DETAILED_READ_COUNTS)
    if parameters.infer_read_haplotypes:
        output_options |= HAPLOTYPES
    else:
        output_options &= ~HAPLOTYPES
    pp = Parameters(
        parameters.max_reads,
        3 if write_alignments else parameters.max_reads + 1,
        0.01, parameters.bad_align_frac, output_options,
        parameters.path_sequence_matching,
        parameters.graph_sequence_matching,
        parameters.klib_sequence_matching,
        parameters.kmer_sequence_matching, False)
    pp.threads = parameters.threads
    pp.kmer_len = parameters.bad_align_uniq_kmer_len
    pp.load(graph_desc, reference_path)
    return pp

