"""Accuracy against the planted truth, printed on a detail line (not part
of ``correct``): frozen copies of ``check_truth`` and ``per_kind_recall``
(``paragraph_tpu_torch/tools/bench_e2e.py``)."""
from __future__ import annotations

import gzip
import json


def check_truth(genotypes_vcf, genotypes_json, events):
    """Score calls against the planted truth and CLASSIFY every miss.

    Returns (n_ok, misses) where each miss is a dict with a `reason`:
      - low_gq           GQ < 10: the model itself says the call is
                         uninformative (e.g. a DUP whose duplicated
                         segment is shorter than the read length, so no
                         read can span it)
      - filtered         FT != PASS (CONFLICT / BP_NO_GT / GQ ...): the
                         pipeline flagged the event as not confidently
                         callable
      - suspect          FT != PASS with GQ >= 10: flagged by the
                         pipeline while the model is confident
      - unexpected       a confident call (PASS, GQ >= 10) that
                         disagrees with the truth: a real defect
    A DEL+SNP event whose VCF call is "." with an UNMATCHED filter counts
    as correct when its breakpoints carry the planted genotype. Without a
    GQ field, GQ is the PL distance from the best genotype to the next.
    """
    calls = {}
    fts = {}
    gqs = {}
    with gzip.open(genotypes_vcf, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            fmt = parts[8].split(":")
            vals = parts[9].split(":")
            pos = int(parts[1])
            calls[pos] = vals[fmt.index("GT")]
            fts[pos] = vals[fmt.index("FT")] if "FT" in fmt else ""
            gq = -1
            if "GQ" in fmt:
                try:
                    gq = int(vals[fmt.index("GQ")])
                except ValueError:
                    pass
            elif "PL" in fmt:
                try:
                    pls = sorted(int(x) for x in
                                 vals[fmt.index("PL")].split(","))
                    gq = pls[1] - pls[0]
                except (ValueError, IndexError):
                    pass
            gqs[pos] = gq
    bp_gts = {}
    with gzip.open(genotypes_json, "rt") as f:
        for rec in json.load(f):
            for bp in rec["samples"]["sample"].get(
                    "breakpoints", {}).values():
                for a in set(bp["counts"]["alleles"]) - {"REF"}:
                    bp_gts.setdefault(a, set()).add(bp["gt"].get("GT", "."))
    n_ok = 0
    misses = []
    for i, ev in enumerate(events):
        got = calls.get(ev["pos"], "missing")
        want = ev["gt"]
        ok = (got == want or (got == "1/0" and want == "0/1")
              or (want == "0/0" and got in ("0/0", "./.")))
        if not ok and ev["kind"] == "DELSNP":
            allele = f"ev{i}:1"
            want_bp = {"0/1": f"REF/{allele}",
                       "1/1": f"{allele}/{allele}",
                       "0/0": "REF/REF"}[want]
            ok = (got == "." and "UNMATCHED" in fts.get(ev["pos"], "")
                  and bp_gts.get(allele) == {want_bp})
        if ok:
            n_ok += 1
            continue
        ft = fts.get(ev["pos"], "")
        gq = gqs.get(ev["pos"], -1)
        if ft not in ("", "PASS"):
            reason = "suspect" if gq >= 10 else "filtered"
        elif 0 <= gq < 10:
            reason = "low_gq"
        else:
            reason = "unexpected"
        misses.append({"event": i, "kind": ev["kind"], "pos": ev["pos"],
                       "want": want, "got": got, "FT": ft, "GQ": gq,
                       "reason": reason})
    return n_ok, misses


def per_kind_recall(events, misses):
    """{kind: {"total": N, "ok": N, "recall": f, <reason counts>}}."""
    missed_by_event = {m["event"]: m["reason"] for m in misses}
    table = {}
    for i, ev in enumerate(events):
        row = table.setdefault(ev["kind"], {"total": 0, "ok": 0})
        row["total"] += 1
        reason = missed_by_event.get(i)
        if reason is None:
            row["ok"] += 1
        else:
            row[reason] = row.get(reason, 0) + 1
    for row in table.values():
        row["recall"] = round(row["ok"] / row["total"], 4)
    return table

