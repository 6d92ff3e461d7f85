"""The benchmark's generator: one seed, one set of bytes; its BAI read back
by the test's own reader; its distributions."""
from __future__ import annotations

import json
import os
from collections import Counter

import numpy as np

from benchmark import generate

from .helpers import SEED, bgzf_blocks, fixture_cell, read_bai, records_at


def _make(tmp_path, name, seed, cell="tiny.catalog"):
    c = fixture_cell(cell)
    out = str(tmp_path / name)
    generate.generate(out, c.config, c.traffic, seed)
    return out, c


def test_same_seed_same_bytes(tmp_path):
    a, _ = _make(tmp_path, "a", SEED)
    b, _ = _make(tmp_path, "b", SEED)
    c, _ = _make(tmp_path, "c", SEED + 1)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    with open(os.path.join(a, "sample.bam"), "rb") as fa, \
            open(os.path.join(c, "sample.bam"), "rb") as fc:
        assert fa.read() != fc.read()


def test_bai_reads_back(tmp_path):
    out, _ = _make(tmp_path, "a", SEED, cell="tiny.catalog")
    bam = os.path.join(out, "sample.bam")
    blocks = bgzf_blocks(bam)
    bins, lin = read_bai(bam + ".bai")
    # every record, by a walk of the whole file after the header block
    first = sorted(blocks)[1]
    every = records_at(blocks, first << 16, max(blocks) << 16)
    pos_all = np.array([p for p, _ in every])
    assert (np.diff(pos_all) >= 0).all()
    assert sum(len(v) for k, v in bins.items() if k != 37450) > 0
    indexed = set()
    for b, chunks in bins.items():
        if b == 37450:
            continue
        for beg, end in chunks:
            indexed.update(v for _, v in records_at(blocks, beg, end))
    assert indexed == {v for _, v in every}
    # the linear index: no record overlapping window w lies before lin[w]
    for p, v in every:
        for w in {p >> 14, (p + 149) >> 14}:
            assert lin[w] <= v
    # the 37450 pseudo-bin: first and end offsets, mapped count
    (beg, end), (mapped, unmapped) = bins[37450]
    assert beg == every[0][1] and mapped == len(every) and unmapped == 0


def test_distributions(tmp_path):
    a, c = _make(tmp_path, "a", SEED)
    b, _ = _make(tmp_path, "b", SEED + 1)
    ev_a = json.load(open(os.path.join(a, "truth.json")))
    ev_b = json.load(open(os.path.join(b, "truth.json")))
    # one multiset of kinds, sizes and genotypes for every seed
    assert sorted((e["kind"], e["size"]) for e in ev_a) == sorted(
        (e["kind"], e["size"]) for e in ev_b)
    assert [e["kind"] for e in ev_a] != [e["kind"] for e in ev_b]
    for s in ev_a[0]["gts"]:
        ga = Counter(e["gts"][s] for e in ev_a)
        assert ga == Counter(e["gts"][s] for e in ev_b)
        assert max(ga.values()) - min(ga.values()) <= 1
    # kinds in the published shares, rounded by largest remainders
    kinds = c.traffic["kinds"]
    total = sum(kinds.values())
    got = Counter(e["kind"] for e in ev_a)
    for k, n in kinds.items():
        assert abs(got[k] - len(ev_a) * n / total) < 1
    # sizes: evenly spaced in probability over the power law
    law = c.traffic["size"]
    lo, hi, x = law["min"], law["max"], law["exponent"]
    for kind in kinds:
        sizes = sorted(e["size"] for e in ev_a if e["kind"] == kind)
        n = len(sizes)
        cdf = [(lo ** (1 - x) - s ** (1 - x)) / (lo ** (1 - x)
                                                  - hi ** (1 - x))
               for s in sizes]
        for k, p in enumerate(cdf):
            assert abs(p - (k + 0.5) / n) < 0.01
    # a long deletion, so reference nodes are cut to their ends
    assert max(e["size"] for e in ev_a if e["kind"] == "DEL") > \
        c.config["options"]["max_ref_node_length"]
    # the gap of reference between one event's end and the next
    for e, f in zip(ev_a, ev_a[1:]):
        span = 0 if e["kind"] == "INS" else e["size"]
        assert f["pos"] - e["pos"] - span == c.traffic["gap"]
    info = json.load(open(os.path.join(a, "inputs.json")))
    depth = (info["reads"]["sample"] * c.config["read_length"]
             / info["ref_len"])
    assert abs(depth - c.config["depth"]) < 0.5
