"""Graph genotyper orchestration: per-sample counts → genotypes JSON.

Equivalent of ``genotyping::GraphGenotyper`` + ``GraphBreakpointGenotyper``
(the reference's src/c++/lib/genotyping/GraphGenotyper.cpp,
GraphBreakpointGenotyper.cpp): accumulates per-sample paragraph outputs,
genotypes every breakpoint × sample with the Poisson model (sex-aware
ploidy), combines breakpoints into a whole-variant genotype, and assembles
the output JSON including population statistics for multi-sample runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..graph.model import SequenceGraph
from .breakpoint_genotyper import (BreakpointGenotyper,
                                   BreakpointGenotyperParameter)
from .breakpoint_stats import create_breakpoint_map
from .combined import combined_genotype
from .genotype import Genotype, GenotypeSet
from .parameters import GenotypingParameters
from .population import PopulationStatistics
from .sample_info import MALE, SampleInfo


class GraphBreakpointGenotyper:
    def __init__(self, graph: SequenceGraph, male_ploidy: int = 2,
                 female_ploidy: int = 2):
        self.graph = graph
        self.male_ploidy = male_ploidy
        self.female_ploidy = female_ploidy

        # reset() (GraphGenotyper.cpp:67-87)
        bp_map = create_breakpoint_map(graph)
        self.breakpoint_names = list(bp_map.keys())
        allele_names = set()
        for bp in bp_map.values():
            allele_names.update(bp.canonical_allele_names)
        self.allele_names = sorted(allele_names)

        self.sample_names: List[str] = []
        self.breakpoint_maps = []
        self.depths: List[Tuple[float, int]] = []
        self.depth_sds: List[float] = []
        self.sexes: List[str] = []
        self.basic_info: dict = {}
        self.genotypes: Dict[Tuple[str, str], Genotype] = {}

        self.p_genotype_parameter: Optional[GenotypingParameters] = None
        self.p_male_genotype_parameter: Optional[GenotypingParameters] = None

    def set_parameters(self, genotyping_parameter_json: Optional[dict] = None):
        """GraphBreakpointGenotyper::setParameters
        (GraphBreakpointGenotyper.cpp:34-45)."""
        self.p_genotype_parameter = GenotypingParameters(
            self.allele_names, self.female_ploidy)
        self.p_male_genotype_parameter = GenotypingParameters(
            self.allele_names, self.male_ploidy)
        if genotyping_parameter_json:
            self.p_genotype_parameter.set_from_json(
                genotyping_parameter_json)

    def add_alignment(self, sample_info: SampleInfo):
        """GraphGenotyper::addAlignment (GraphGenotyper.cpp:101-230)."""
        samplename = sample_info.sample_name
        alignment = sample_info.alignment_data
        self.sample_names.append(samplename)
        bp_map = create_breakpoint_map(self.graph)
        for bp in bp_map.values():
            bp.add_counts(alignment)
        self.breakpoint_maps.append(bp_map)
        self.depths.append(
            (sample_info.autosome_depth, sample_info.read_length))
        self.depth_sds.append(sample_info.depth_sd)
        self.sexes.append(sample_info.sex)

        if "eventinfo" in alignment:
            if "eventinfo" in self.basic_info:
                assert alignment["eventinfo"] == self.basic_info["eventinfo"]
            else:
                self.basic_info["eventinfo"] = alignment["eventinfo"]

        if "graphinfo" not in self.basic_info:
            self.basic_info["graphinfo"] = {}
            gi = self.basic_info["graphinfo"]
            if "ID" in alignment:
                gi["ID"] = alignment["ID"]
            elif "vcf_records" in alignment:
                event_id = ",".join(
                    rec["id"] for rec in alignment["vcf_records"]
                    if "id" in rec)
                gi["ID"] = event_id

            if "breakpointinfo" not in self.basic_info:
                self.basic_info["breakpointinfo"] = []
                for bp_name, bp in self.breakpoint_maps[-1].items():
                    value = {"name": bp_name, "mapped_alleles": {}}
                    for allele in bp.all_allele_names:
                        canonical = bp.get_canonical_allele_name(allele)
                        if canonical != allele:
                            value["mapped_alleles"][allele] = canonical
                    self.basic_info["breakpointinfo"].append(value)

            for key in ("target_regions", "sequencenames"):
                gi[key] = alignment.get(key)
            gi["nodes"] = []
            for n in alignment.get("nodes", []):
                node = {"name": n["name"]}
                if "sequences" in n:
                    node["sequences"] = n["sequences"]
                gi["nodes"].append(node)
            gi["edges"] = []
            for e in alignment.get("edges", []):
                edge = {"name": e["from"] + "_" + e["to"]}
                if "sequences" in e:
                    edge["sequences"] = e["sequences"]
                gi["edges"].append(edge)

        self.basic_info.setdefault("samples", {})
        self.basic_info["samples"][samplename] = dict(
            alignment.get("alignment_statistics", {}))
        stat_json = self.basic_info["samples"][samplename]
        for k, v in alignment.get("fragment_statistics", {}).items():
            if k not in ("linear_histogram", "graph_histogram"):
                stat_json[k] = v

    def get_sample_ploidy(self, sample_index: int) -> int:
        if self.sexes[sample_index] == MALE:
            return self.male_ploidy
        return self.female_ploidy

    def collect_jobs(self):
        """Every (breakpoint × sample) genotyping work item:
        [(samplename, bp_name, b_param, counts, is_male)]. The engines
        below (and the device population engine,
        genotyping/device_engine.py) evaluate these in batches and hand
        results back via install_genotypes()."""
        jobs = []
        for bp_name in self.breakpoint_names:
            for sample_index, samplename in enumerate(self.sample_names):
                depth, read_length = self.depths[sample_index]
                counts = [
                    self.breakpoint_maps[sample_index][bp_name].get_count(e)
                    for e in self.allele_names
                ]
                sample_ploidy = self.get_sample_ploidy(sample_index)
                expected_depth = depth * (sample_ploidy / self.female_ploidy)
                b_param = BreakpointGenotyperParameter(
                    expected_depth, read_length,
                    self.depth_sds[sample_index],
                    self.p_genotype_parameter.use_poisson_depth)
                jobs.append((samplename, bp_name, b_param, counts,
                             sample_ploidy == self.male_ploidy))
        return jobs

    def install_genotypes(self, by_key):
        """Store per-(sample × breakpoint) genotypes computed by any
        engine, then derive each sample's whole-variant combined
        genotype (GraphBreakpointGenotyper.cpp:83-103)."""
        self.genotypes.update(by_key)
        genotyper = BreakpointGenotyper(self.p_genotype_parameter)
        for sample_index, samplename in enumerate(self.sample_names):
            all_bp_gts = GenotypeSet()
            for bp_name in self.breakpoint_names:
                all_bp_gts.add(
                    self.allele_names,
                    self.genotypes.get((samplename, bp_name), Genotype()))
            depth, read_length = self.depths[sample_index]
            b_param = BreakpointGenotyperParameter(
                depth, read_length, self.depth_sds[sample_index],
                self.p_genotype_parameter.use_poisson_depth)
            self.genotypes[(samplename, "")] = combined_genotype(
                all_bp_gts, b_param, genotyper)

    def run_genotyping(self):
        """GraphBreakpointGenotyper::runGenotyping
        (GraphBreakpointGenotyper.cpp:47-103).

        The per-(breakpoint × sample) likelihood evaluation runs through
        the vectorized float64 engine (genotyping/vectorized.py) — one
        batch per ploidy class instead of the reference's scalar loop —
        with bitwise-identical results (tests/test_vectorized_genotyper
        .py). PARAGRAPH_TPU_GT_ENGINE=scalar restores the loop; the
        float32 device engine runs via genotyping/device_engine.py
        (grmpy --genotyping-engine device), which batches jobs across
        EVENTS, not per event like this path.
        """
        import os

        use_vectorized = os.environ.get(
            "PARAGRAPH_TPU_GT_ENGINE", "vectorized") != "scalar"
        jobs = self.collect_jobs()
        results = {}
        if use_vectorized:
            import numpy as np

            from .vectorized import VectorizedBreakpointGenotyper

            for is_male in (False, True):
                job_list = [j for j in jobs if j[4] == is_male]
                if not job_list:
                    continue
                param = (self.p_male_genotype_parameter if is_male
                         else self.p_genotype_parameter)
                vec = VectorizedBreakpointGenotyper(param)
                batch = vec.genotype_batch(
                    [j[2] for j in job_list],
                    np.asarray([j[3] for j in job_list], np.int64))
                for (samplename, bp_name, _, _, _), gt in zip(
                        job_list, batch):
                    results[(samplename, bp_name)] = gt
        else:
            genotyper = BreakpointGenotyper(self.p_genotype_parameter)
            male_genotyper = BreakpointGenotyper(
                self.p_male_genotype_parameter)
            for samplename, bp_name, b_param, counts, is_male in jobs:
                engine = male_genotyper if is_male else genotyper
                results[(samplename, bp_name)] = engine.genotype(
                    b_param, counts)
        self.install_genotypes(results)

    def get_genotypes(self) -> dict:
        """GraphGenotyper::getGenotypes (GraphGenotyper.cpp:235-338)."""
        if not self.genotypes:  # device engine installs them up front
            self.run_genotyping()
        result = _deep_copy(self.basic_info)
        samples = result.setdefault("samples", {})
        for samplename in self.sample_names:
            samples.setdefault(samplename, {})["breakpoints"] = {}

        genotype_sets: Dict[str, GenotypeSet] = {}
        for isample, samplename in enumerate(self.sample_names):
            breakpoints = self.breakpoint_maps[isample]
            for bp_name in sorted(breakpoints):
                this_set = genotype_sets.setdefault(bp_name, GenotypeSet())
                gt = self.genotypes.get((samplename, bp_name))
                if gt is not None:
                    this_set.add(self.allele_names, gt)
                    bp_json = {}
                    samples[samplename]["breakpoints"][bp_name] = bp_json
                    bp_json["gt"] = gt.to_json(self.allele_names)
                    bp = breakpoints[bp_name]
                    bp_json["counts"] = {
                        "edges": {e: bp.get_count(e)
                                  for e in bp.edge_names},
                        "alleles": {a: bp.get_count(a)
                                    for a in bp.canonical_allele_names},
                    }
                else:
                    this_set.add([], Genotype())

            this_set = genotype_sets.setdefault("", GenotypeSet())
            gt = self.genotypes.get((samplename, ""))
            if gt is not None:
                this_set.add(self.allele_names, gt)
                samples[samplename]["gt"] = gt.to_json(self.allele_names)
            else:
                this_set.add([], Genotype())
                samples[samplename]["gt"] = Genotype().to_json([])

        if len(self.sample_names) > 1:
            # std::map iteration: "" (whole variant) sorts first and
            # initialises the population object, then breakpoints nest under
            # population.breakpoints (GraphGenotyper.cpp:314-335)
            pop: dict = {}
            result["population"] = pop
            for bp_name in sorted(genotype_sets):
                ps = PopulationStatistics(genotype_sets[bp_name])
                if bp_name == "":
                    pop.update(ps.to_json())
                else:
                    pop.setdefault("breakpoints", {})[bp_name] = ps.to_json()

        return result


def _deep_copy(obj):
    """Deep copy for JSON-typed data (basic_info is parsed graph JSON).
    Hand-rolled because copy.deepcopy's generic machinery was a visible
    slice of per-event genotyping time; non-JSON leaves fall back to
    copy.deepcopy."""
    t = type(obj)
    if t is dict:
        return {k: _deep_copy(v) for k, v in obj.items()}
    if t is list:
        return [_deep_copy(v) for v in obj]
    if t in (str, int, float, bool, type(None)):
        return obj
    import copy

    return copy.deepcopy(obj)
