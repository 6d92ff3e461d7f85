from .parameters import GenotypingParameters
from .genotype import Genotype
from .breakpoint_genotyper import BreakpointGenotyper, BreakpointGenotyperParameter
from .combined import combined_genotype
from .breakpoint_stats import BreakpointStatistics, create_breakpoint_map
from .sample_info import SampleInfo, load_manifest

__all__ = [
    "GenotypingParameters",
    "Genotype",
    "BreakpointGenotyper",
    "BreakpointGenotyperParameter",
    "combined_genotype",
    "BreakpointStatistics",
    "create_breakpoint_map",
    "SampleInfo",
    "load_manifest",
]
