"""Ablation harness of the multi-event graph-SW fill: the twelve variants of
its column loop as a hand-written CUDA kernel (``ops/csrc/kbench_sw.cu``
on ``ops/csrc/kbench_warp.cuh``).

Counterpart of the JAX package's ``tools/kbench2.py``. Each variant is
the paired fill's column step on its warp-per-lane layout (a warp per
lane, each thread's rows in registers, as ``ops/csrc/sw_warp.cuh``) with
one or more parts of the TPU harness's v0 put back or taken away, so the
time between two variants prices one part of that step (the source
header gives each knob's meaning). The exact ones (``EXACT``) give the
multi-event fill's outputs; the others (nof, opt1_nof, opt2_nof: no F;
notrack: no end-cell tracking; nobranch: no node seeding or saving) are
wrong on purpose and exist to attribute time. The variants run on K2's
tables (``MultiFillTables``: read codes already expanded into their
orientation).

    python -m paragraph_tpu_torch.tools.kbench2 [--device cuda]
        [--variants v0,opt2,...] [--k 4] [--reads 8192] [--readlen 150]
        [--m 0] [--check]

The case is kbench's bench dispatch. ``--check`` prints ``check <name>:
EXACT|MISMATCH`` for every variant listed: its kernel against its plain
fill (for the exact variants, the multi-event fill's plain version, so
they also equal v0). Otherwise each variant is
timed as the best of 3 runs over K distinct code buffers (the first code
row shifted by i), per dispatch: ms and issued Gcells/s per variant,
then one JSON line. The orientation expansion is done once per buffer,
before the timed runs (the JAX harness timed it inside them).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..ops import _build
from ..ops.multi_sw import (WARP_LANES_PER_CTA, FillTables,
                            MultiFillTables, _bucket, _fill_reference,
                            _pack_split, check_multi_tables,
                            expand_orientations, warp_grid)
from . import kbench

#: the variants, in the order of the kernel's variant ids, with the JAX
#: harness's keywords
VARIANTS = {
    "v0": {},
    "nof": {"scan": False},
    "notrack": {"track": False},
    "nobranch": {"branches": False},
    "hoist": {"hoist": True},
    "unroll2": {"unroll": 2},
    "hoist_u2": {"hoist": True, "unroll": 2},
    "opt1": {"_opt": True},
    "opt1_iprof": {"_opt": True, "inline_prof": True},
    "opt1_nof": {"_opt": True, "scan": False},
    "opt2": {"_opt2": True},
    "opt2_nof": {"_opt2": True, "scan": False},
}
#: the variants whose outputs are the multi-event fill's
EXACT = ("v0", "hoist", "unroll2", "hoist_u2", "opt1", "opt1_iprof",
         "opt2")
#: the JAX harness's scoring (build_fill's constants)
SCORING = {"gap_open": 6, "gap_extend": 1, "match": 1, "mismatch": 4}
#: the JAX scorer's floor on read rows when --m is not given
M_FLOOR = 160


def tpu_body(variant: str) -> str:
    """The TPU kernel body a variant ablates (tools/kbench2.py)."""
    kw = VARIANTS[variant]
    if kw.get("_opt"):
        return "make_kernel_opt"
    if kw.get("_opt2"):
        return "make_kernel_opt2"
    return "make_kernel"


def _switches(variant: str) -> dict:
    kw = VARIANTS[variant]
    return {k: kw.get(k, True) for k in ("scan", "track", "branches")}


def _check_variant(t: MultiFillTables, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    unroll = VARIANTS[variant].get("unroll", 1)
    if unroll > 1 and bool((t.tile_col_len % unroll != 0).any()):
        raise ValueError(f"{variant} walks {unroll} columns a step: every "
                         f"tile's column count must be a multiple of it")


def kbench_fill_reference(t: MultiFillTables, variant: str):
    """A variant's fill in plain PyTorch ops: [4, B] int32 on t's device.

    It is the multi-event fill (multi_fill_reference) with the variant's
    functional switches (F, end-cell tracking, node branches); the
    structural knobs (hoisting, unrolling, scalar tracking, the profile
    table, the clamp of E) do not change what a variant computes."""
    import torch

    _check_variant(t, variant)
    return _fill_reference(
        t.packed_cols, t.pred_tables, t.tile_col_start, t.tile_col_len,
        t.tile_event, t.read_codes_t.to(torch.int32), t.lens[0], t.vlens[0],
        t.l_ev, **SCORING, **_switches(variant))


def kbench_fill(t: MultiFillTables, variant: str):
    """A variant's fill: [4, B] int32 on t's device.

    On CUDA tensors this launches the variant's kernel of
    ops/csrc/kbench_sw.cu on the current stream, sized by warp_grid, and
    raises on anything it cannot take (more read rows than the kernels
    take, gap_open < gap_extend, an odd column count for the unroll
    variants); on CPU tensors it runs kbench_fill_reference.
    ``kbench_fill.launches`` counts kernel launches."""
    dev = t.device
    if dev.type == "cpu":
        return kbench_fill_reference(t, variant)
    if dev.type != "cuda":
        raise ValueError(f"kbench_fill runs on cuda or cpu, not {dev}")
    _check_variant(t, variant)
    check_multi_tables(t)
    n_ev, N, P = t.pred_tables.shape
    M, B = t.read_codes_t.shape
    TB = B // t.tile_event.shape[0]
    col_bits, _ = _pack_split(t.l_ev, M, SCORING["match"])
    grid, words = warp_grid(N, M, B, SCORING["gap_open"],
                            SCORING["gap_extend"])
    out = _build.launch(
        "kbench_sw_launch", dev, words, B,
        [list(VARIANTS).index(variant), t.packed_cols, t.pred_tables,
         t.tile_col_start, t.tile_col_len, t.tile_event, t.read_codes_t,
         t.lens, t.vlens],
        [B, TB, N, P, M, WARP_LANES_PER_CTA, grid, SCORING["gap_open"],
         SCORING["gap_extend"], SCORING["match"], SCORING["mismatch"],
         col_bits])
    kbench_fill.launches += 1
    return out


kbench_fill.launches = 0


def expanded_tables(t: FillTables, m: int = 0) -> MultiFillTables:
    """K2's tables of a paired dispatch: each lane's codes expanded into
    its orientation, with rows of pad code 5 added up to `m` rows."""
    import torch

    x, lens, vlens = expand_orientations(t)
    if m > x.shape[0]:
        pad = torch.full((m - x.shape[0], x.shape[1]), 5, dtype=x.dtype,
                         device=x.device)
        x = torch.cat([x, pad])
    return MultiFillTables(
        t.packed_cols, t.pred_tables, t.tile_col_start, t.tile_col_len,
        t.tile_event, read_codes_t=x.to(torch.int8).contiguous(),
        lens=lens[None, :].contiguous(), vlens=vlens[None, :].contiguous(),
        l_ev=t.l_ev)


def rows_for(m: int, read_len: int) -> int:
    """Read rows of the bench's tables by the JAX harness's --m rule: at
    least m (M_FLOOR when m is 0) and the read length rounded up to 8 (32
    when m is 0)."""
    return max(m or M_FLOOR, _bucket(read_len, 8 if m else 32))


def bench_buffers(k: int, n_reads: int, read_len: int, m: int, device):
    """K2 tables of the bench dispatch for k distinct code buffers (buffer
    i has the first code row of every read shifted by i, modulo 4), and
    the dispatch's issued cells."""
    sw, reads = kbench.build(n_reads=n_reads, read_len=read_len,
                             device=device)
    t, host = kbench.bench_tables(sw, reads)
    rows = max(rows_for(m, read_len), host["m"])
    bufs = []
    for i in range(k):
        codes = t.base_codes_t.clone()
        codes[0] = (codes[0] + i) % 4
        bufs.append(expanded_tables(
            dataclasses.replace(t, base_codes_t=codes), rows))
    return bufs, kbench.issued_cells(host, rows)


def time_variants(bufs, variants, reps: int = 3) -> dict:
    """{variant: ms per dispatch}: after one warm-up launch, the best of
    `reps` runs over every buffer back to back."""
    dev = bufs[0].device
    out = {}
    for name in variants:
        kbench_fill(bufs[0], name)

        def run():
            for b in bufs:
                kbench_fill(b, name)

        out[name] = min(kbench.time_ms(run, 1, dev)
                        for _ in range(reps)) / len(bufs)
    return out


def check_variants(t: MultiFillTables, variants) -> dict:
    """{variant: (its fill, its plain fill)} on the same tables. The plain
    fill (kbench_fill_reference) is computed once per set of functional
    switches, so every exact variant is held to the same one: the
    multi-event fill's."""
    plain, out = {}, {}
    for name in variants:
        key = tuple(_switches(name).values())
        if key not in plain:
            plain[key] = kbench_fill_reference(t, name)
        out[name] = (kbench_fill(t, name), plain[key])
    return out


def main(argv=None) -> int:
    from .. import resolve_device

    ap = argparse.ArgumentParser("kbench2")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--reads", type=int, default=kbench.N_READS)
    ap.add_argument("--m", type=int, default=0)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--readlen", type=int, default=kbench.READ_LEN)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")

    device = resolve_device(args.device)
    bufs, cells = bench_buffers(args.k, args.reads, args.readlen, args.m,
                                device)
    t = bufs[0]
    M, B = t.read_codes_t.shape
    print(f"shapes: L={t.packed_cols.shape[0]} L_ev={t.l_ev} "
          f"N={t.pred_tables.shape[1]} P={t.pred_tables.shape[2]} M={M} "
          f"TB={B // t.tile_event.shape[0]} B={B} cells/dispatch={cells:.3e}",
          file=sys.stderr)

    if args.check:
        import torch

        exact = {name: torch.equal(got, want) for name, (got, want)
                 in check_variants(t, variants).items()}
        for name, ok in exact.items():
            print(f"check {name}: {'EXACT' if ok else 'MISMATCH'}",
                  flush=True)
        return 0 if all(exact.values()) else 1

    ms = time_variants(bufs, variants)
    results = {}
    for name in variants:
        results[name] = {"per_dispatch_ms": ms[name],
                         "gcells": cells / ms[name] / 1e6}
        print(f"{name}: {ms[name]:.3f}ms {cells / ms[name] / 1e6:.1f} "
              f"Gcells/s", flush=True)
    print(json.dumps({"device": kbench.device_name(device), "cells": cells,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
