"""fetch_behind_k1_share.realign: share (%) of the host's time in
scorer.fetch spans (blocked on a dispatch's output) in which the card
runs a K1 launched by a later dispatch than the one fetched
(benchmark/program_spans.py). None where the program has no fetch spans
or no kernel could be joined to a launch span."""

from benchmark import program_spans


def read(run):
    summary = program_spans.of_run(run)
    fetch = (summary or {}).get("fetch") or {}
    if not fetch.get("total_s") or "behind_later_s" not in fetch:
        return None
    return 100.0 * fetch["behind_later_s"] / fetch["total_s"]
