from .regions import Region, parse_region
from .fasta import FastaFile
from .bam import BamReader
from .vcf import VcfReader, VcfWriter, VcfRecord

__all__ = [
    "Region",
    "parse_region",
    "FastaFile",
    "BamReader",
    "VcfReader",
    "VcfWriter",
    "VcfRecord",
]
