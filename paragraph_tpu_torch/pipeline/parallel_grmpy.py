"""Pipelined multi-process grmpy: extraction → device scoring → analysis.

Counterpart of ``paragraph_tpu/pipeline/parallel_grmpy.py``. The run is
cut into rounds of events and three resources are overlapped:

  worker processes   extract round k+1      (BAM/CRAM I/O + decode)
  device             scores round k         (one paired scorer per round,
                                             ops/multi_sw.py)
  worker processes   analyse round k-1      (traceback, disambiguation,
                                             counting, genotyping)

Scoring happens only in the parent, on the caller's device, or sharded
over the caller's mesh when it holds several devices
(parallel/distributed.py). Workers are
spawned with the card hidden (``CUDA_VISIBLE_DEVICES=""``), never score,
and raise if a pair that needs scores arrives without them. With the
device genotyping engine the workers return each event's samples instead
of genotyping them, and the parent genotypes the whole run in one
``device_genotype`` stage on its device (genotyping/device_engine.py).
Output is event-ordered and identical to the batch path.
"""
from __future__ import annotations

import concurrent.futures
import copy
import logging
import multiprocessing
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..graph.model import SequenceGraph
from ..utils.profiling import span

logger = logging.getLogger("grmpy")

_WORKER_STATE: Dict[str, object] = {}


def _worker_init():
    _WORKER_STATE["readers"] = {}
    _WORKER_STATE["event_reads"] = {}
    # pre-import the analysis stack while the parent is still converting
    # input and extracting round 0
    from ..reads.extraction import extract_reads  # noqa: F401
    from .grmpy import count_and_genotype  # noqa: F401
    from .paragraph import align_and_disambiguate  # noqa: F401


def _get_reader(filename: str, index_filename: str, reference_path: str):
    readers = _WORKER_STATE.setdefault("readers", {})
    reader = readers.get(filename)
    if reader is None:
        from ..io.cram import open_alignment_reader

        reader = open_alignment_reader(filename, index_filename,
                                       reference_path)
        readers[filename] = reader
    return reader


def _extract_reads_map(graph_desc: dict, reference_path: str,
                       bam_specs: List[tuple], max_reads: int):
    """{sample_name: [Read, ...]} for one event (the extraction half of
    grmpy::alignSingleSample, AlignSamples.cpp:115-147)."""
    from ..reads.extraction import extract_reads
    from .paragraph import Parameters

    pp = Parameters()
    pp.max_reads = max_reads
    pp.load(graph_desc, reference_path)
    out = {}
    for sample_name, filename, index_filename in bam_specs:
        reader = _get_reader(filename, index_filename, reference_path)
        out[sample_name] = extract_reads(
            reader, pp.target_regions, pp.max_reads,
            pp.longest_alt_insertion)
    return out


def _extract_event(gi: int, graph_desc: dict, reference_path: str,
                   bam_specs: List[tuple], max_reads: int):
    """Extract one event's reads, keep the Read objects in this worker
    (the event's analysis task is routed back here), and return what the
    parent's scoring needs: per sample, the upper-cased bases of
    scoreable reads as one blob + lengths."""
    reads_map = _extract_reads_map(graph_desc, reference_path, bam_specs,
                                   max_reads)
    _WORKER_STATE.setdefault("event_reads", {})[gi] = reads_map
    out = {}
    for sample_name, reads in reads_map.items():
        bases = [r.bases.upper() for r in reads if r.bases]
        lens = np.fromiter((len(b) for b in bases), np.int32,
                           count=len(bases))
        out[sample_name] = ("".join(bases).encode(), lens)
    return out


def _analyze_event(gi: int, graph_desc: dict, reference_path: str,
                   genotyping_parameters: Optional[dict],
                   parameters, per_sample: List[tuple],
                   bam_specs: List[tuple], max_reads: int,
                   defer_genotyping: bool = False):
    """Per-event host analysis + genotyping for all samples.

    per_sample: (SampleInfo, has_reads, precomputed scores);
    has_reads=False means the sample carries pre-aligned alignment_data.
    Reads come from this worker's extraction cache; a cache miss (e.g. a
    worker restart) re-extracts locally. Returns the event's genotyping
    result dict (CountAndGenotype.cpp), or with `defer_genotyping` the
    event's samples with their alignment data, for the parent's device
    engine.
    """
    from ..reads.read import UNMAPPED
    from .grmpy import _make_paragraph_parameters, count_and_genotype
    from .paragraph import align_and_disambiguate

    missing = [s.sample_name for s, has_reads, scores in per_sample
               if has_reads and scores is None]
    if missing:
        raise ValueError(f"event {gi}: no device scores for samples "
                         f"{missing}; workers do not score")
    reads_map = _WORKER_STATE.setdefault("event_reads", {}).pop(gi, None)
    if reads_map is None and any(h for _, h, _ in per_sample):
        reads_map = _extract_reads_map(graph_desc, reference_path,
                                       bam_specs, max_reads)

    # one native traceback thread per worker: the orchestrator already
    # runs one worker process per host core
    parameters = copy.copy(parameters)
    parameters.threads = 1

    pp = None
    graph = None
    samples = []
    for sample, has_reads, scores in per_sample:
        if has_reads:
            reads = reads_map[sample.sample_name]
            if pp is None:
                pp = _make_paragraph_parameters(
                    parameters, graph_desc, reference_path, False)
                graph = SequenceGraph.from_json(
                    pp.description, reference_path)
            for r in reads:
                if r.bases:
                    r.graph_mapping_status = UNMAPPED
            output = align_and_disambiguate(
                pp, reads, graph=graph, precomputed_scores=scores)
            output["bam"] = sample.filename
            for key in ("alignments", "node_coverage", "path_coverage",
                        "phasing", "variants"):
                output.pop(key, None)
            sample.alignment_data = output
        samples.append(sample)
    if defer_genotyping:
        return samples
    return count_and_genotype(graph_desc, reference_path,
                              genotyping_parameters, samples, graph=graph)


def run_grmpy_pipelined(graph_descs: List[dict], reference_path: str,
                        manifest, genotyping_parameters: Optional[dict],
                        parameters, round_events: int = 0,
                        workers: int = 0, device="cuda",
                        kernel_stats: Optional[dict] = None,
                        mesh=None) -> List[dict]:
    """Event-ordered genotyping results for every graph, produced by the
    3-stage pipeline described in the module docstring. Each round is
    scored over `mesh` (default ``make_event_mesh(device)``): one
    ``ShardedPairedSW`` when it holds more than one device, else one
    ``PairedGraphSW`` on `device`. The round scorers' stats and the
    device engine's are added into `kernel_stats` when given, and the
    stage seconds into its `stage_s`."""
    from .. import resolve_device
    from ..align.batched_aligner import resolve_threads
    from ..align.native import native_available
    from ..ops.multi_sw import PAIR_BUDGET
    from ..parallel.distributed import make_event_mesh
    from .grmpy import resolve_gt_engine

    # initialise the devices before the card is hidden from the children
    device = resolve_device(device)
    if mesh is None:
        mesh = make_event_mesh(device)
    # build the native traceback library here, once: workers that race on
    # its first build fail to load it and trace back in Python, about 50x
    # slower, for the rest of their life
    if not native_available():
        logger.warning("native traceback library unavailable (make -C "
                       "native failed); workers trace back in Python")
    workers = workers or resolve_threads(parameters.threads)
    n_events = len(graph_descs)
    if not round_events:
        # single-sample rounds of 32 events fill one dispatch; multi-
        # sample rounds shrink so a round is a few full chunks
        n_align = max(1, sum(1 for s in manifest
                             if s.alignment_data is None))
        round_events = 32 if n_align == 1 else max(
            8, (PAIR_BUDGET // n_align) or 1)
    rounds = [list(range(r, min(r + round_events, n_events)))
              for r in range(0, n_events, round_events)]

    needs_align = [s for s in manifest if s.alignment_data is None]
    bam_specs = [(s.sample_name, s.filename, s.index_filename)
                 for s in needs_align]
    defer_genotyping = resolve_gt_engine(parameters, len(manifest),
                                         n_events) == "device"

    t_start = time.monotonic()
    progress_state = {"last": t_start}

    def report_progress(done: int) -> None:
        if not parameters.progress:
            return
        now = time.monotonic()
        if done == n_events or now - progress_state["last"] >= 10.0:
            progress_state["last"] = now
            logger.info("[progress] %d/%d events done", done, n_events)

    ctx = multiprocessing.get_context("spawn")
    # children inherit os.environ at spawn: they never see the card
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        return _run_pipeline(
            ctx, workers, rounds, graph_descs, reference_path, manifest,
            needs_align, bam_specs, genotyping_parameters, parameters,
            report_progress, n_events, device,
            {} if kernel_stats is None else kernel_stats, defer_genotyping,
            mesh)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def _run_pipeline(ctx, workers, rounds, graph_descs, reference_path,
                  manifest, needs_align, bam_specs, genotyping_parameters,
                  parameters, report_progress, n_events, device,
                  kernel_stats, defer_genotyping, mesh):
    from .. import add_stats
    from ..ops.multi_sw import PairedGraphSW
    from ..parallel.distributed import ShardedPairedSW

    extract_futs: Dict[int, object] = {}
    analysis_futs: List[Optional[object]] = [None] * n_events

    # one single-worker pool per host core: event gi's extraction AND
    # analysis both go to pool gi % W, so the Read objects extracted
    # there are still in that worker's cache when analysis arrives
    pools = [concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=ctx, initializer=_worker_init)
        for _ in range(workers)]
    try:

        def submit_extract(r: int) -> None:
            for gi in rounds[r]:
                extract_futs[gi] = pools[gi % workers].submit(
                    _extract_event, gi, graph_descs[gi], reference_path,
                    bam_specs, parameters.max_reads)

        def finalize_and_analyze(pending) -> None:
            r, sw, handle = pending
            with pipeline_stage(kernel_stats, "device_wait+submit"):
                scores = None
                if handle is not None:
                    scores = sw.finalize_pairs(handle)
                    add_stats(kernel_stats, sw.stats)
                k = 0
                for gi in rounds[r]:
                    per_sample = []
                    for s in manifest:  # manifest order = output order
                        if s.alignment_data is not None:
                            per_sample.append((copy.copy(s), False, None))
                            continue
                        f_out, r_out = scores[k]
                        k += 1
                        per_sample.append((copy.copy(s), True, (
                            f_out[0], f_out[4], r_out[4],
                            f_out[1], f_out[2], f_out[3])))
                    analysis_futs[gi] = pools[gi % workers].submit(
                        _analyze_event, gi, graph_descs[gi], reference_path,
                        genotyping_parameters, parameters, per_sample,
                        bam_specs, parameters.max_reads, defer_genotyping)

        def build_sw(r: int):
            """Scorer for round r. Graphs derive from the descriptions
            alone, so construction (tables + device uploads) runs while
            the round's extraction is still in flight in the workers."""
            if not needs_align:
                return None
            graphs = []
            for gi in rounds[r]:
                graph = SequenceGraph.from_json(
                    _root_desc(graph_descs[gi]), reference_path)
                graphs.extend([graph] * len(needs_align))
            if len(mesh) > 1:
                return ShardedPairedSW(graphs, mesh)
            return PairedGraphSW(graphs, device=device)

        pending_score = None
        submit_extract(0)
        with pipeline_stage(kernel_stats, "graph_build"):
            prebuilt_sw = {0: build_sw(0)} if rounds else {}
        for r in range(len(rounds)):
            if r + 1 < len(rounds):
                submit_extract(r + 1)
            sw = prebuilt_sw.pop(r, None)
            with pipeline_stage(kernel_stats, "extract_wait"):
                blobs_by_event = {gi: extract_futs.pop(gi).result()
                                  for gi in rounds[r]}

            # one scoring batch per (event x sample), in the pair order
            # build_sw laid the graphs out; (blob, lens) tuples go
            # straight to the scorer
            with pipeline_stage(kernel_stats, "score_dispatch"):
                batches = [blobs_by_event[gi][s.sample_name]
                           for gi in rounds[r] for s in needs_align]
                handle = sw.score_pairs_device(batches) if sw is not None \
                    else None

            if pending_score is not None:
                finalize_and_analyze(pending_score)
            pending_score = (r, sw, handle)

            # overlap the next round's scorer construction with its
            # extraction and with the device scoring round r
            if r + 1 < len(rounds):
                with pipeline_stage(kernel_stats, "graph_build"):
                    prebuilt_sw[r + 1] = build_sw(r + 1)

            done = sum(1 for f in analysis_futs if f is not None
                       and f.done())
            report_progress(done)

        if pending_score is not None:
            finalize_and_analyze(pending_score)

        results = []
        if defer_genotyping:
            from ..genotyping.device_engine import genotype_events_on_device
            from .grmpy import make_event_genotyper

            with pipeline_stage(kernel_stats, "analysis_wait"):
                genotypers = [make_event_genotyper(
                    graph_descs[gi], reference_path, genotyping_parameters,
                    analysis_futs[gi].result()) for gi in range(n_events)]
            with pipeline_stage(kernel_stats, "device_genotype"):
                genotype_events_on_device(genotypers, device, kernel_stats,
                                          mesh=mesh)
                for gi, gtr in enumerate(genotypers):
                    results.append(gtr.get_genotypes())
                    report_progress(gi + 1)
        else:
            with pipeline_stage(kernel_stats, "analysis_wait"):
                for gi in range(n_events):
                    results.append(analysis_futs[gi].result())
                    report_progress(gi + 1)
        if kernel_stats.get("dispatches"):
            k1_s = kernel_stats.get("k1_s", 0.0)
            cells = kernel_stats.get("cells", 0)
            logger.info(
                "[kernel] dispatches=%d cells=%.2fG k1=%.2fs "
                "eff=%.1f Gcells per K1 second; host: tables=%.2fs "
                "put=%.2fs call=%.2fs fetch=%.2fs slice=%.2fs",
                kernel_stats["dispatches"], cells / 1e9, k1_s,
                cells / k1_s / 1e9 if k1_s > 0 else 0.0,
                kernel_stats.get("tables_s", 0.0),
                kernel_stats.get("put_s", 0.0),
                kernel_stats.get("call_s", 0.0),
                kernel_stats.get("device_wait_s", 0.0),
                kernel_stats.get("slice_s", 0.0))
    finally:
        for ex in pools:
            ex.shutdown(wait=False, cancel_futures=True)
    return results


def pipeline_stage(kernel_stats: dict, key: str) -> span:
    """The span ``pipeline.<key>``, its seconds added into
    ``kernel_stats["stage_s"][key]``."""
    return span("pipeline." + key, kernel_stats.setdefault("stage_s", {}),
                key)


def log_stages(kernel_stats: Optional[dict]) -> None:
    """The ``[pipeline] stage seconds`` line of a finished job."""
    if kernel_stats and kernel_stats.get("stage_s"):
        logger.info("[pipeline] stage seconds: %s",
                    {k: round(v, 2)
                     for k, v in sorted(kernel_stats["stage_s"].items())})


def _root_desc(graph_desc: dict) -> dict:
    root = dict(graph_desc)
    if "graph" in root:
        root.update(root["graph"])
        del root["graph"]
    return root
