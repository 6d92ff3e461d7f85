"""The benchmark's own input generator: a synthetic SV catalogue and the
paired reads of each sample over it, from one seed, in NumPy.

The catalogue is a traffic mix's: deletions and insertions in the shares
of its published kind counts, sizes evenly spaced in probability over a
power law, a random contig with a fixed gap of reference between events,
genotypes 0/1, 1/1 and 0/0 in equal shares per sample. Kinds, sizes and
genotypes are the same multiset for every seed, in the seed's order.
Fragments are drawn uniformly over both haplotypes to the configured
depth, read pairs taken from their ends, substitutions at the configured
rate. It writes:

- ``ref.fa`` and ``ref.fa.fai``; ``candidates.vcf`` (and ``warmup.vcf``,
  the first events of the same catalogue); ``samples.txt`` (the
  multigrmpy manifest); ``truth.json`` (the planted events);
- ``<sample>.bam`` and ``<sample>.bam.bai``: fixed-size records, whole
  records in each BGZF block, so the index is written from the offsets
  the writer chose, with no second read;
- ``graphs.json`` (each event's graph in paragraph's graph-JSON input
  format, flanks of one read length, reference nodes over
  ``max_ref_node_length`` cut to their two ends) and ``reads.npz`` (the
  first sample's reads that start inside each event's window, as stored
  in the BAM).

Nothing here imports ``paragraph_tpu`` or ``paragraph_tpu_torch``.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
#: BAM's 4-bit base codes of A, C, G, T
_NIB = np.array([1, 2, 4, 8], np.uint8)
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
GENOTYPES = ("0/1", "1/1", "0/0")
CONTIG = "chrS"


def _threads() -> int:
    return len(os.sched_getaffinity(0))


def bgzf_block(data: bytes, level: int = 1) -> bytes:
    """One BGZF block (the BSIZE extra field, raw deflate, CRC, ISIZE)."""
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(data) + comp.flush()
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<HBBHH", 6, 66, 67, 2, len(cdata) + 25))
    return header + cdata + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                        len(data))


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM specification's reg2bin, vectorised (end exclusive)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = offset + (beg[hit] >> shift)
        done |= hit
    return out


def kind_plan(rng, n_events: int, mix: dict):
    """Each event's kind: the shares of the mix's published counts
    (``kinds``: kind -> count), rounded by largest remainders, in the
    seed's order."""
    names = list(mix["kinds"])
    share = np.array([mix["kinds"][k] for k in names], float)
    share = n_events * share / share.sum()
    counts = np.floor(share).astype(np.int64)
    for j in np.argsort(counts - share, kind="stable")[
            :n_events - int(counts.sum())]:
        counts[j] += 1
    return [str(k) for k in rng.permutation(np.repeat(names, counts))]


def size_grid(n: int, mix: dict) -> np.ndarray:
    """`n` sizes evenly spaced in probability over the mix's ``size`` law
    (``min``, ``max``, ``exponent``): a density falling as size **
    -exponent between the bounds."""
    law = mix["size"]
    a, b, k = law["min"], law["max"], law["exponent"]
    u = (np.arange(n) + 0.5) / max(n, 1)
    lo, hi = a ** (1.0 - k), b ** (1.0 - k)
    return np.rint((lo + u * (hi - lo)) ** (1.0 / (1.0 - k))).astype(
        np.int64)


def plant_events(rng, n_events: int, mix: dict, sample_names):
    """The catalogue: kinds, sizes, per-sample genotypes and inserted
    sequence, events ``gap`` bases of reference apart (from one event's
    end to the next). Returns (events, ref codes)."""
    first = mix["first_pos"]
    kind_of = kind_plan(rng, n_events, mix)
    # every seed draws the same multiset of sizes and genotypes, in
    # another order: the seed changes where the work lies, not how much
    sizes = np.zeros(n_events, np.int64)
    for kind in sorted(set(kind_of)):
        idx = np.flatnonzero(np.asarray(kind_of) == kind)
        sizes[idx] = rng.permutation(size_grid(len(idx), mix))
    gt_draw = np.stack([rng.permutation(np.arange(n_events) % 3)
                        for _ in sample_names], 1)
    spans = np.where(np.asarray(kind_of) == "INS", 0, sizes)
    pos = first + np.concatenate([[0], np.cumsum(spans + mix["gap"])])
    ref = rng.integers(0, 4, int(pos[-1]) + first).astype(np.uint8)
    events = []
    for i, kind in enumerate(kind_of):
        gts = {name: GENOTYPES[gt_draw[i, k]]
               for k, name in enumerate(sample_names)}
        events.append({"kind": kind, "pos": int(pos[i]),
                       "size": int(sizes[i]), "gt": gts[sample_names[0]],
                       "gts": gts})
    for ev in events:
        if ev["kind"] == "INS":
            ev["ins_seq"] = BASES[rng.integers(0, 4, ev["size"])].tobytes(
            ).decode()
    return events, ref


def _rc(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[..., ::-1]


def haplotype(ref: np.ndarray, events, sample: str, hap: int):
    """One haplotype's codes and its anchors (hap start, ref start, run
    length) of the runs copied from the reference."""
    parts = []
    anchors = []
    cur = 0
    hap_len = 0
    for ev in events:
        gt = ev["gts"][sample]
        alt = gt == "1/1" or (gt == "0/1" and hap == 1)
        seg = ref[cur:ev["pos"]]
        anchors.append((hap_len, cur, ev["pos"] - cur))
        parts.append(seg)
        hap_len += len(seg)
        cur = ev["pos"]
        if not alt:
            continue
        if ev["kind"] == "DEL":
            cur = ev["pos"] + ev["size"]
            continue
        extra = np.frombuffer(ev["ins_seq"].encode(), np.uint8)
        extra = np.searchsorted(BASES, extra).astype(np.uint8)
        parts.append(extra)
        hap_len += len(extra)
    anchors.append((hap_len, cur, len(ref) - cur))
    parts.append(ref[cur:])
    return np.concatenate(parts), np.asarray(anchors, np.int64)


def hap_to_ref(anchors: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Reference position of haplotype offsets `s` (offsets inside
    inserted sequence map to the end of the run before them)."""
    k = np.searchsorted(anchors[:, 0], s, side="right") - 1
    hs, rs, ln = anchors[k, 0], anchors[k, 1], anchors[k, 2]
    return rs + np.minimum(s - hs, np.maximum(ln - 1, 0))


def simulate_reads(rng, ref, events, sample: str, cfg: dict):
    """One sample's read pairs, sorted by position: (pos, mate pos,
    flag, tlen, codes[n, L], fragment ids)."""
    rl, fl = cfg["read_length"], cfg["fragment_length"]
    n_frags = len(ref) * cfg["depth"] // (2 * 2 * rl)
    cols = []
    for hap in (0, 1):
        seq, anchors = haplotype(ref, events, sample, hap)
        start = rng.integers(0, len(seq) - fl, n_frags)
        r1 = seq[start[:, None] + np.arange(rl)]
        r2 = seq[(start + fl - rl)[:, None] + np.arange(rl)]
        p1 = hap_to_ref(anchors, start)
        p2 = hap_to_ref(anchors, start + fl - rl)
        ids = np.arange(n_frags) * 2 + hap
        cols.append((r1, r2, p1, p2, ids))
    r1, r2, p1, p2, ids = (np.concatenate(c) for c in zip(*cols))
    for r in (r1, r2):
        hit = rng.random(r.shape) < cfg["substitution_rate"]
        r[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
    n = len(ids)
    # R1 forward at p1 (flag 99), R2 reverse-complemented at p2 (147),
    # each fragment's R1 before its R2 before sorting by position
    codes = np.empty((2 * n, rl), np.uint8)
    codes[0::2] = r1
    codes[1::2] = _rc(r2)
    pos = np.empty(2 * n, np.int64)
    pos[0::2], pos[1::2] = p1, p2
    mpos = np.empty(2 * n, np.int64)
    mpos[0::2], mpos[1::2] = p2, p1
    flag = np.tile(np.array([99, 147], np.int64), n)
    tlen = np.tile(np.array([fl, -fl], np.int64), n)
    frag = np.repeat(ids, 2)
    order = np.argsort(pos, kind="stable")
    return (pos[order], mpos[order], flag[order], tlen[order],
            codes[order], frag[order])


def _record_dtype(name_len: int, rl: int):
    return np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
        ("name", f"S{name_len}"), ("cigar", "<u4"),
        ("seq", "u1", ((rl + 1) // 2,)), ("qual", "u1", (rl,))])


def write_bam(path: str, ref_len: int, reads, cfg: dict) -> int:
    """Write one sample's BAM and its BAI; returns the records written."""
    pos, mpos, flag, tlen, codes, frag = reads
    n, rl = codes.shape
    names = np.char.add(b"s", np.char.zfill(frag.astype("S9"), 9))
    dt = _record_dtype(11, rl)
    rec = np.zeros(n, dt)
    rec["block_size"] = dt.itemsize - 4
    rec["pos"], rec["next_pos"], rec["tlen"] = pos, mpos, tlen
    rec["l_name"] = 11
    rec["mapq"] = cfg["mapq"]
    bins = reg2bin(pos, pos + rl)
    rec["bin"] = bins
    rec["n_cigar"] = 1
    rec["flag"] = flag
    rec["l_seq"] = rl
    rec["name"] = names
    rec["cigar"] = rl << 4  # one M
    nib = _NIB[codes]
    if rl % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], 1)
    rec["seq"] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    rec["qual"] = cfg["base_quality"]
    raw = rec.view(np.uint8).reshape(n, dt.itemsize)

    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{CONTIG}\tLN:{ref_len}\n"
            ).encode()
    header = (b"BAM\x01" + struct.pack("<i", len(text)) + text
              + struct.pack("<ii", 1, len(CONTIG) + 1) + CONTIG.encode()
              + b"\x00" + struct.pack("<i", ref_len))
    per_block = 65280 // dt.itemsize
    chunks = [raw[i:i + per_block].tobytes() for i in range(0, n,
                                                            per_block)]
    with ThreadPoolExecutor(_threads()) as pool:
        blocks = list(pool.map(bgzf_block, chunks))
    head = bgzf_block(header)
    coff = np.cumsum([len(head)] + [len(b) for b in blocks])
    with open(path, "wb") as f:
        f.write(head)
        for b in blocks:
            f.write(b)
        f.write(_BGZF_EOF)

    # virtual offsets: record i sits in block i // per_block
    k = np.arange(n)
    blk = k // per_block
    voff = (coff[blk] << 16) | ((k % per_block) * dt.itemsize)
    vend = np.append(voff[1:], coff[-1] << 16)
    last_in_block = (k % per_block == per_block - 1) | (k == n - 1)
    vend[last_in_block] = coff[blk[last_in_block] + 1] << 16
    write_bai(path + ".bai", pos, pos + rl, bins, voff, vend)
    return n


def write_bai(path: str, beg, end, bins, voff, vend) -> None:
    """One reference's BAI: merged chunks per bin, the 37450 pseudo-bin
    and the 16 kb linear index."""
    n = len(beg)
    order = np.lexsort((np.arange(n), bins))
    b_sorted = bins[order]
    new = np.ones(n, bool)
    new[1:] = (b_sorted[1:] != b_sorted[:-1]) | (np.diff(order) != 1)
    starts = np.flatnonzero(new)
    stops = np.append(starts[1:], n) - 1
    chunk_bin = b_sorted[starts]
    chunk_beg = voff[order[starts]]
    chunk_end = vend[order[stops]]
    out = [b"BAI\x01", struct.pack("<i", 1)]
    uniq, first = np.unique(chunk_bin, return_index=True)
    counts = np.diff(np.append(first, len(chunk_bin)))
    out.append(struct.pack("<i", len(uniq) + 1))
    for b, f0, c in zip(uniq, first, counts):
        out.append(struct.pack("<Ii", int(b), int(c)))
        pairs = np.stack([chunk_beg[f0:f0 + c], chunk_end[f0:f0 + c]], 1)
        out.append(pairs.astype("<u8").tobytes())
    out.append(struct.pack("<IiQQQQ", 37450, 2, int(voff[0]),
                           int(vend[-1]), n, 0))
    w_beg, w_end = beg >> 14, (end - 1) >> 14
    lin = np.full(int(w_end.max()) + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(lin, w_beg, voff)
    np.minimum.at(lin, w_end, voff)
    full = lin != np.iinfo(np.int64).max
    # an empty window takes the offset of the last window before it
    # that holds a read (0 before the first)
    last = np.maximum.accumulate(np.where(full, np.arange(len(lin)), -1))
    lin = np.where(last >= 0, lin[np.maximum(last, 0)], 0)
    out.append(struct.pack("<i", len(lin)))
    out.append(lin.astype("<u8").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _text(codes: np.ndarray) -> str:
    return BASES[codes].tobytes().decode()


def write_vcf(path: str, ref, events, ref_len: int) -> None:
    lines = ["##fileformat=VCFv4.2",
             f"##contig=<ID={CONTIG},length={ref_len}>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for i, ev in enumerate(events):
        p, s = ev["pos"], ev["size"]
        anchor = _text(ref[p - 1:p])
        if ev["kind"] == "DEL":
            ref_allele, alt = _text(ref[p - 1:p + s]), anchor
        else:
            ref_allele, alt = anchor, anchor + ev["ins_seq"]
        lines.append(f"{CONTIG}\t{p}\tev{i}\t{ref_allele}\t{alt}\t.\tPASS\t.")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_fasta(path: str, ref) -> None:
    text = _text(ref)
    body = "\n".join(text[i:i + 60] for i in range(0, len(text), 60))
    with open(path, "w") as f:
        f.write(f">{CONTIG}\n{body}\n")
    with open(path + ".fai", "w") as f:
        f.write(f"{CONTIG}\t{len(ref)}\t{len(CONTIG) + 2}\t60\t61\n")


def event_graph(ref, ev, flank: int, max_ref_node: int) -> dict:
    """One event's graph in paragraph's graph-JSON input format: ordered
    nodes (reference nodes as 1-based regions, alleles as sequence) and
    edges; a reference node longer than `max_ref_node` keeps its two
    ends of `flank` bases, joined by an edge, as multigrmpy's conversion
    cuts long reference nodes."""
    p, s, kind = ev["pos"], ev["size"], ev["kind"]
    nodes, edges = [], []

    def ref_node(name, a, b):
        """Node(s) over 0-based [a, b); returns (first name, last name)."""
        if b - a > max_ref_node:
            nodes.append({"name": name + "a",
                          "reference": f"{CONTIG}:{a + 1}-{a + flank}"})
            nodes.append({"name": name + "b",
                          "reference": f"{CONTIG}:{b - flank + 1}-{b}"})
            edges.append((name + "a", name + "b"))
            return name + "a", name + "b"
        nodes.append({"name": name, "reference": f"{CONTIG}:{a + 1}-{b}"})
        return name, name

    def seq_node(name, seq):
        nodes.append({"name": name, "sequence": seq})
        return name, name

    left = ref_node("L", p - flank, p)
    if kind == "DEL":
        body = ref_node("D", p, p + s)
        right = ref_node("R", p + s, p + s + flank)
        edges += [(left[1], body[0]), (body[1], right[0]),
                  (left[1], right[0])]
    else:
        alt = seq_node("I", ev["ins_seq"])
        right = ref_node("R", p, p + flank)
        edges += [(left[1], alt[0]), (alt[1], right[0]),
                  (left[1], right[0])]
    regions = [n["reference"] for n in nodes if "reference" in n]
    lo = min(int(r.split(":")[1].split("-")[0]) for r in regions)
    hi = max(int(r.split("-")[1]) for r in regions)
    return {"nodes": nodes,
            "edges": [{"from": a, "to": b} for a, b in edges],
            "target_regions": [f"{CONTIG}:{lo}-{hi}"]}


def realign_batches(reads, graphs, read_length: int):
    """The reads (as stored) that start inside each event's window, from
    one read length before its first graph base to its last: (codes,
    per-event offsets into them)."""
    pos, codes = reads[0], reads[4]
    picked, offsets = [], [0]
    for g in graphs:
        lo, hi = g["target_regions"][0].split(":")[1].split("-")
        a = np.searchsorted(pos, int(lo) - 1 - read_length, "left")
        b = np.searchsorted(pos, int(hi), "left")
        picked.append(codes[a:b])
        offsets.append(offsets[-1] + (b - a))
    return np.concatenate(picked), np.asarray(offsets, np.int64)


def generate(out_dir: str, cfg: dict, mix: dict, seed: int) -> dict:
    """Write the seed's inputs for (deployment `cfg`, traffic `mix`) into
    `out_dir`; returns the summary written to ``inputs.json``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = ["sample"] + [f"sample{k}" for k in range(1, cfg["samples"])]
    n_events = mix["events"]
    events, ref = plant_events(rng, n_events, mix, names)
    write_fasta(os.path.join(out_dir, "ref.fa"), ref)
    write_vcf(os.path.join(out_dir, "candidates.vcf"), ref, events, len(ref))
    if "warmup_events" in mix:
        write_vcf(os.path.join(out_dir, "warmup.vcf"), ref,
                  events[:mix["warmup_events"]], len(ref))
    n_reads = {}
    first_reads = None
    for name in names:
        reads = simulate_reads(rng, ref, events, name, cfg)
        n_reads[name] = write_bam(os.path.join(out_dir, f"{name}.bam"),
                                  len(ref), reads, cfg)
        if first_reads is None:
            first_reads = reads
    graphs = [event_graph(ref, ev, cfg["read_length"],
                          cfg["options"]["max_ref_node_length"])
              for ev in events]
    with open(os.path.join(out_dir, "graphs.json"), "w") as f:
        json.dump(graphs, f)
    codes, offsets = realign_batches(first_reads, graphs, cfg["read_length"])
    np.savez(os.path.join(out_dir, "reads.npz"), codes=codes,
             offsets=offsets)
    with open(os.path.join(out_dir, "truth.json"), "w") as f:
        json.dump(events, f)
    summary = {"seed": seed, "events": n_events, "samples": names,
               "reads": n_reads, "ref_len": int(len(ref))}
    with open(os.path.join(out_dir, "inputs.json"), "w") as f:
        json.dump(summary, f)
    return summary


def write_manifest(out_dir: str, cfg: dict, names) -> str:
    """samples.txt with this directory's absolute BAM paths."""
    path = os.path.join(out_dir, "samples.txt")
    with open(path, "w") as f:
        f.write("id\tpath\tdepth\tread length\n")
        for name in names:
            bam = os.path.join(os.path.abspath(out_dir), f"{name}.bam")
            f.write(f"{name}\t{bam}\t{cfg['depth']}\t{cfg['read_length']}\n")
    return path
